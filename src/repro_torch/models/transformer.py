"""Pattern-chain transformer LM, the dense-GQA and Mamba-2 parts (port
of ``repro.models.transformer``).

The reference stacks each pattern position's parameters across the
repeats and runs the stack with one ``lax.scan``; the port keeps one
parameter dict a layer and loops over the layers (PyTorch runs eagerly,
so there is nothing to compile once).  The layer order is the
reference's: the prologue, then the pattern repeated ``repeats`` times
(:attr:`TransformerLM.descs`).

Three modes, one code path (:meth:`TransformerLM.trunk`):

  - ``train``:   the full sequence, causal (K10 an attention layer, K12 a
                 Mamba layer), no cache; :meth:`TransformerLM.loss` runs
                 it under autograd, each pattern repeat recomputed in the
                 backward as ``cfg.remat`` says;
  - ``prefill``: as train, and returns each layer's cache (KV rows, or
                 the Mamba conv tail and SSM state);
  - ``decode``:  one token a sequence against the caches (K11 an
                 attention layer, plain ops a Mamba layer), written in
                 place.

Ported: attention mixers (``attn``, GQA with optional SWA and biases)
with dense SwiGLU MLPs -- granite, stablelm, command-r, llama3 -- and
Mamba-2 mixers without an MLP (``mlp="none"``) -- mamba2.  Configs that
need another mixer or MLP, cross-attention or an encoder raise
``NotImplementedError`` naming the ROADMAP item that ports them.

Training (:meth:`TransformerLM.loss`, reference ``:401``): the token
cross-entropy of the final hidden states, chunked over the sequence under
``cfg.loss_chunk``.  On the card an attention layer's backward is K10's,
written by hand (``kernels/flash_attention.py`` ``FlashAttention``, f32
operands; a bf16 one raises); on the CPU autograd differentiates the
plain versions.  A config with a Mamba layer raises under grad on any
device: K12 has no backward yet (ROADMAP.md queue 2).  ``encode`` and
the MoE losses wait with their blocks (``NOT_PORTED``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ArchConfig, BlockDesc, layer_plan
from repro_torch.kernels.mamba_ssd import K12_BACKWARD
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mamba_mod
from repro_torch.models.layers import (cross_entropy, embed_init, rmsnorm,
                                       rmsnorm_init, swiglu, swiglu_init)

Params = Dict[str, Any]
#: One dict a layer, ``{"attn": {"k", "v"}}`` or ``{"mamba": {"conv",
#: "ssm"}}``, every leaf ``[B, ...]``.
Cache = List[Dict[str, Any]]

#: What this port does not run yet: the reference's code it is to port
#: (ROADMAP.md queue 1 has the item).
NOT_PORTED = {
    "mla": "repro/models/attention.py mla_* (MLA, with K11 at head dim 576)",
    "moe": "repro/models/moe.py (MoE and the hybrid/MoE configs)",
    "cross": "repro/models/attention.py cross_* and "
             "repro/models/transformer.py TransformerLM.encode "
             "(cross-attention and encoder-decoder LMs)",
}
NOT_PORTED["enc_dec"] = NOT_PORTED["cross"]


def _attn_dims(cfg: ArchConfig) -> attn.AttnDims:
    return attn.AttnDims(
        d_model=cfg.d_model, n_q=cfg.n_heads, n_kv=cfg.n_kv_heads,
        head_dim=cfg.dh, window=cfg.window, rope_theta=cfg.rope_theta,
        bias=cfg.qkv_bias)


def _mamba_dims(cfg: ArchConfig) -> mamba_mod.MambaDims:
    m = cfg.mamba
    return mamba_mod.MambaDims(
        d_model=cfg.d_model, d_state=m.d_state, headdim=m.headdim,
        expand=m.expand, d_conv=m.d_conv, chunk=m.chunk)


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def check_ported(cfg: ArchConfig, desc: BlockDesc) -> None:
    """Raise ``NotImplementedError`` for a block this port cannot run."""
    for what in (desc.mixer if desc.mixer not in ("attn", "mamba")
                 else None,
                 desc.mlp if desc.mlp not in ("dense", "none") else None,
                 "cross" if desc.cross else None,
                 "enc_dec" if cfg.enc_dec else None):
        if what is not None:
            port = NOT_PORTED.get(what)
            raise NotImplementedError(
                f"{cfg.name}: {what!r} blocks are not ported yet ("
                + (f"the reference's {port}; " if port else "")
                + "ROADMAP.md queue 1)")


# ---------------------------------------------------------------------------
# One block (attention or Mamba mixer + optional dense MLP), pre-norm
# residual
# ---------------------------------------------------------------------------

def block_init(generator: torch.Generator, cfg: ArchConfig, desc: BlockDesc,
               device=None) -> Params:
    check_ported(cfg, desc)
    dt = dtype_of(cfg.param_dtype)
    device = generator.device if device is None else device
    p: Params = {"norm1": rmsnorm_init(cfg.d_model, dt, device)}
    if desc.mixer == "attn":
        p["attn"] = attn.gqa_init(generator, _attn_dims(cfg), dt, device)
    else:
        p["mamba"] = mamba_mod.mamba_init(generator, _mamba_dims(cfg), dt,
                                          device)
    if desc.mlp == "dense":
        p["norm2"] = rmsnorm_init(cfg.d_model, dt, device)
        p["mlp"] = swiglu_init(generator, cfg.d_model, cfg.d_ff, dt, device)
    return p


def block_cache(cfg: ArchConfig, desc: BlockDesc, batch: int, max_len: int,
                *, dtype=torch.bfloat16, device="cuda") -> Dict[str, Any]:
    """Zeroed decode cache for one block.  SWA caches are rolling buffers
    of ``window`` rows; a Mamba block's SSM state is float32 whatever
    ``dtype``, its conv tail at ``dtype``."""
    check_ported(cfg, desc)
    if desc.mixer == "mamba":
        return {"mamba": mamba_mod.mamba_empty_cache(
            _mamba_dims(cfg), batch, dtype, device)}
    L = min(max_len, cfg.window) if cfg.window else max_len
    return {"attn": attn.gqa_empty_cache(_attn_dims(cfg), batch, L, dtype,
                                         device)}


def block_apply(params: Params, x: torch.Tensor, desc: BlockDesc,
                cfg: ArchConfig, *, mode: str,
                positions: Optional[torch.Tensor] = None,
                cache: Optional[Dict[str, Any]] = None,
                cache_pos: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """One pre-norm block.  Returns ``(x, cache)``: the block's fresh
    (prefill) or updated (decode) cache, ``None`` in train mode."""
    check_ported(cfg, desc)
    h = rmsnorm(params["norm1"], x)
    key = desc.mixer
    if key == "attn":
        y, c = attn.gqa_apply(params["attn"], h, positions,
                              dims=_attn_dims(cfg), mode=mode,
                              cache=None if cache is None else cache["attn"],
                              cache_pos=cache_pos)
    else:
        y, c = mamba_mod.mamba_apply(
            params["mamba"], h, dims=_mamba_dims(cfg), mode=mode,
            cache=None if cache is None else cache["mamba"])
    x = x + y
    if desc.mlp == "dense":
        x = x + swiglu(params["mlp"], rmsnorm(params["norm2"], x))
    return x, (None if c is None else {key: c})


# ---------------------------------------------------------------------------
# Rematerialisation (the reference's ``_maybe_remat``)
# ---------------------------------------------------------------------------

#: The products "dots" keeps: matrix products with no batch dimension, as
#: the reference's ``dots_with_no_batch_dims_saveable``; einsum runs such a
#: product as a ``bmm`` of one batch.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _DOTS or (op == torch.ops.aten.bmm.default
                       and args[0].shape[0] == 1):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _dots_contexts():
    return ckpt.create_selective_checkpoint_contexts(_dots_policy)


def remat(fn, mode: str):
    """``fn`` as ``cfg.remat`` asks (reference ``_maybe_remat``, ``:290``):
    ``"none"`` as it is; ``"full"`` saving only its inputs and recomputing
    the rest in the backward; ``"dots"`` saving the outputs of its matrix
    products with no batch dimension and recomputing the rest.  Through
    ``torch.utils.checkpoint`` (non-reentrant); no value changes."""
    if mode == "none":
        return fn
    if mode not in ("full", "dots"):
        raise ValueError(f"unknown remat mode {mode!r}")
    kw = {"context_fn": _dots_contexts} if mode == "dots" else {}
    return lambda *args: ckpt.checkpoint(fn, *args, use_reentrant=False,
                                         **kw)


# ---------------------------------------------------------------------------
# The LM
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TransformerLM:
    """Decoder-only LM over an :class:`ArchConfig` (attention + dense MLP
    blocks, or Mamba-2 blocks).  Constructing it over a config with blocks this port does
    not run raises ``NotImplementedError``."""

    cfg: ArchConfig

    def __post_init__(self):
        for d in self.descs:
            check_ported(self.cfg, d)

    @property
    def plan(self) -> Tuple[List[BlockDesc], List[BlockDesc], int]:
        """The reference's ``(prologue, pattern, repeats)`` (``:225``)."""
        return layer_plan(self.cfg)

    @property
    def descs(self) -> List[BlockDesc]:
        """One :class:`BlockDesc` a layer, in the reference's order."""
        prologue, pattern, repeats = self.plan
        return list(prologue) + list(pattern) * repeats

    # -- init ----------------------------------------------------------------
    def init(self, generator: torch.Generator, device="cuda") -> Params:
        """Random weights from ``generator`` (drawn on its device; a CUDA
        generator builds a full-size model on the card), at the config's
        ``param_dtype`` on ``device``.  The vocab is padded to 256; the
        pad rows are masked out of the logits."""
        cfg = self.cfg
        dt = dtype_of(cfg.param_dtype)
        params: Params = {
            "embed": embed_init(generator, cfg.vocab_padded, cfg.d_model, dt,
                                device),
            "final_norm": rmsnorm_init(cfg.d_model, dt, device)}
        if not cfg.tie_embeddings:
            params["lm_head"] = embed_init(generator, cfg.vocab_padded,
                                           cfg.d_model, dt, device)
        params["layers"] = [block_init(generator, cfg, d, device)
                            for d in self.descs]
        return params

    # -- the trunk -----------------------------------------------------------
    def trunk(self, params: Params, x: torch.Tensor, *, mode: str,
              positions: Optional[torch.Tensor] = None,
              cache: Optional[Cache] = None,
              cache_pos: Optional[torch.Tensor] = None,
              ) -> Tuple[torch.Tensor, Optional[Cache]]:
        """Every layer in order; returns ``(x, cache)``, the cache a list
        of one dict a layer (prefill, decode) or ``None`` (train)."""
        if mode == "train" and cache is None and torch.is_grad_enabled() \
                and self.cfg.remat != "none":
            return self._train_trunk(params, x, positions), None
        new_cache: Optional[Cache] = [] if mode in ("prefill", "decode") \
            else None
        for i, (desc, layer) in enumerate(zip(self.descs, params["layers"])):
            x, c = block_apply(layer, x, desc, self.cfg, mode=mode,
                               positions=positions,
                               cache=None if cache is None else cache[i],
                               cache_pos=cache_pos)
            if new_cache is not None:
                new_cache.append(c)
        return x, new_cache

    def _train_trunk(self, params: Params, x: torch.Tensor,
                     positions: Optional[torch.Tensor]) -> torch.Tensor:
        """The train-mode trunk under ``cfg.remat``, as the reference
        remats it: the prologue's blocks as they are, each repeat of the
        pattern (the reference's scan body) as one unit."""
        prologue, pattern, repeats = self.plan
        descs, layers = self.descs, params["layers"]

        def run(x, first, n, *units):
            for desc, layer in zip(descs[first:first + n], units):
                x = block_apply(layer, x, desc, self.cfg, mode="train",
                                positions=positions)[0]
            return x

        n0 = len(prologue)
        x = run(x, 0, n0, *layers[:n0])
        body = remat(run, self.cfg.remat)
        for r in range(repeats):
            first = n0 + r * len(pattern)
            x = body(x, first, len(pattern),
                     *layers[first:first + len(pattern)])
        return x

    # -- heads ---------------------------------------------------------------
    def logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """``[..., vocab_padded]`` at ``x``'s type; the pad columns are
        -1e30, so no argmax or softmax lands on them."""
        x = rmsnorm(params["final_norm"], x)
        head = params["embed"] if self.cfg.tie_embeddings \
            else params["lm_head"]
        out = x @ head.t()
        if self.cfg.vocab_padded != self.cfg.vocab:
            out[..., self.cfg.vocab:] = -1e30
        return out

    def embed(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        return params["embed"][tokens].to(dtype_of(self.cfg.compute_dtype))

    # -- training ------------------------------------------------------------
    def _loss_from_hidden(self, params: Params, x: torch.Tensor,
                          labels: torch.Tensor
                          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Token CE of the final hidden ``x`` ``[B, S, D]`` (reference
        ``:366``); with ``cfg.loss_chunk`` shorter than ``S``, over
        ``S // chunk`` chunks of the sequence so that the ``[B, S, V]``
        logits never stand whole (the tail past the last whole chunk left
        out, as in the reference), their token-weighted mean."""
        chunk = self.cfg.loss_chunk
        if not chunk or x.shape[1] <= chunk:
            return cross_entropy(self.logits(params, x), labels)
        tot = tok = torch.zeros((), dtype=torch.float32, device=x.device)
        for c in range(x.shape[1] // chunk):
            sl = slice(c * chunk, (c + 1) * chunk)
            loss, m = cross_entropy(self.logits(params, x[:, sl]),
                                    labels[:, sl])
            tot = tot + loss * m["tokens"]
            tok = tok + m["tokens"]
        loss = tot / torch.clamp(tok, min=1.0)
        return loss, {"nll": loss, "tokens": tok}

    def loss(self, params: Params, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The training objective of one (micro)batch (reference
        ``:401``): ``batch`` holds ``tokens`` and ``labels`` ``[B, S]``.
        Returns ``(loss, {"nll", "tokens", "loss"})``.  Under grad, a
        config with a Mamba layer raises ``NotImplementedError``: K12 has
        no backward."""
        if torch.is_grad_enabled() and any(d.mixer == "mamba"
                                           for d in self.descs):
            raise NotImplementedError(f"{self.cfg.name}: {K12_BACKWARD}")
        tokens, labels = batch["tokens"], batch["labels"]
        S = tokens.shape[1]
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
        x = self.embed(params, tokens)
        x, _ = self.trunk(params, x, mode="train", positions=positions)
        loss, metrics = self._loss_from_hidden(params, x, labels)
        metrics["loss"] = loss
        return loss, metrics

    # -- serving -------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, *, dtype=None,
                   device="cuda") -> Cache:
        """Zeroed caches of ``batch`` sequences, one dict a layer, at the
        config's ``compute_dtype`` unless ``dtype`` says otherwise."""
        dtype = dtype or dtype_of(self.cfg.compute_dtype)
        return [block_cache(self.cfg, d, batch, max_len, dtype=dtype,
                            device=device) for d in self.descs]

    def prefill(self, params: Params, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, Cache]:
        """Full-sequence pass over ``tokens`` ``[B, S]`` building the
        caches; returns the last position's logits ``[B, V]`` and the
        caches (``[B, n_kv, S, Dh]`` K/V an attention layer; the conv
        tail and the float32 SSM state a Mamba layer)."""
        S = tokens.shape[1]
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
        x = self.embed(params, tokens)
        x, cache = self.trunk(params, x, mode="prefill", positions=positions)
        return self.logits(params, x[:, -1:, :])[:, 0], cache

    def decode_step(self, params: Params, cache: Cache, tokens: torch.Tensor,
                    positions: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
        """One new token a sequence.  ``tokens``: ``[B, 1]``;
        ``positions``: ``[B]`` int32 absolute positions (= each cache's
        fill).  The caches are written in place and returned."""
        x = self.embed(params, tokens)
        x, cache = self.trunk(params, x, mode="decode", cache=cache,
                              cache_pos=positions)
        return self.logits(params, x)[:, 0], cache
