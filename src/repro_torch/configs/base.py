"""Config schema + layer-pattern planner (port of
``repro.configs.base``, data only).

Every architecture is described declaratively; :func:`layer_plan` turns a
config into ``(prologue, pattern, repeats)`` — a possibly-heterogeneous
repeating block pattern (each pattern position is one vertex function;
the chain of repeats is the input graph).  The reference stacks the
repeats' parameters and scans over them; the port's
``models/transformer.py`` keeps one parameter dict per layer and loops.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoECfg:
    num_experts: int
    top_k: int
    num_shared: int = 0
    every: int = 1          # MoE MLP every k-th layer (others dense)
    first_dense: int = 0    # first k layers use a dense MLP
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class MLACfg:
    kv_lora: int = 512
    nope_dim: int = 128
    rope_dim: int = 64
    v_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MambaCfg:
    d_state: int = 128
    headdim: int = 64
    expand: int = 2
    d_conv: int = 4
    chunk: int = 128
    attn_every: int = 0     # hybrid: every k-th layer is attention (0 = none)


@dataclasses.dataclass(frozen=True)
class BlockDesc:
    """One vertex function in the pattern chain."""

    mixer: str              # "attn" | "mla" | "mamba"
    mlp: str                # "dense" | "moe" | "none"
    cross: bool = False     # extra cross-attention sublayer


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str             # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None

    # attention
    attn_kind: str = "gqa"  # gqa | mla
    window: Optional[int] = None
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    mla: Optional[MLACfg] = None

    # mlp / moe
    moe: Optional[MoECfg] = None

    # ssm / hybrid
    mamba: Optional[MambaCfg] = None

    # multimodal / enc-dec
    cross_every: int = 0    # every k-th layer has cross-attention (vlm)
    cross_kv_len: int = 0   # frontend tokens (image patches / audio frames)
    enc_dec: bool = False
    enc_layers: int = 0

    # numerics & memory
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    tie_embeddings: bool = False
    remat: str = "none"     # none | full | dots
    loss_chunk: Optional[int] = None   # chunked CE (memory optimization)

    # distribution hints
    fsdp: bool = False
    sp: bool = False                   # sequence-parallel residual stream
    n_micro: int = 1                   # grad-accum microbatches at train_4k
    opt_moment_dtype: str = "float32"  # AdamW moment dtype (bf16 ≥ 400B)
    expert_axis: str = "experts"       # "experts" (EP) or "ff" (TP) sharding
    notes: str = ""

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to 256 so the vocab dim tiles any mesh axis.

        A non-divisible vocab silently loses its sharding constraint and
        replicates the full [B, S, V] logits on every device — measured
        ~1 TB/device/step on seamless-m4t (V=256206 ∤ 16).  Padding rows
        are masked to -inf before the loss/argmax (Megatron convention).
        """
        return -(-self.vocab // 256) * 256

    @property
    def subquadratic(self) -> bool:
        """Eligible for long_500k (sub-quadratic sequence mixing)."""
        return self.mamba is not None or self.window is not None

    @property
    def decoder_layers(self) -> int:
        return self.num_layers

    def param_count(self) -> int:
        """Total parameters (for 6·N·D model-FLOPs accounting)."""
        return _count_params(self, active_only=False)

    def active_param_count(self) -> int:
        """Per-token active parameters (MoE: only routed top-k)."""
        return _count_params(self, active_only=True)


# ---------------------------------------------------------------------------
# Pattern planner
# ---------------------------------------------------------------------------

def _desc_for_layer(cfg: ArchConfig, i: int) -> BlockDesc:
    if cfg.mamba is not None:
        ae = cfg.mamba.attn_every
        mixer = "attn" if (ae and i % ae == ae // 2) else "mamba"
    elif cfg.attn_kind == "mla":
        mixer = "mla"
    else:
        mixer = "attn"
    if cfg.mamba is not None and cfg.moe is None and cfg.d_ff == 0:
        mlp = "none"                       # pure mamba blocks (mamba2)
    elif cfg.moe is not None and i >= cfg.moe.first_dense \
            and (i % cfg.moe.every == cfg.moe.every - 1
                 if cfg.moe.every > 1 else True):
        mlp = "moe"
    else:
        mlp = "dense"
    cross = bool(cfg.cross_every and i % cfg.cross_every == cfg.cross_every - 1)
    return BlockDesc(mixer=mixer, mlp=mlp, cross=cross)


def layer_plan(cfg: ArchConfig) -> Tuple[List[BlockDesc], List[BlockDesc], int]:
    """→ (prologue descs, repeating pattern descs, repeats).

    The pattern period is the lcm of all layer-type periodicities; the
    prologue absorbs boundary irregularities (e.g. DeepSeek's first
    dense layer).
    """
    descs = [_desc_for_layer(cfg, i) for i in range(cfg.num_layers)]
    n_pro = cfg.moe.first_dense if cfg.moe else 0
    prologue, body = descs[:n_pro], descs[n_pro:]
    # Find the smallest period that tiles the body.
    for period in range(1, len(body) + 1):
        if len(body) % period:
            continue
        if all(body[i] == body[i % period] for i in range(len(body))):
            return prologue, body[:period], len(body) // period
    return prologue, body, 1


# ---------------------------------------------------------------------------
# Parameter counting (per-config closed form via the plan)
# ---------------------------------------------------------------------------

def _block_params(cfg: ArchConfig, desc: BlockDesc, active_only: bool) -> int:
    D, F = cfg.d_model, cfg.d_ff
    n = 0
    if desc.mixer == "attn":
        n += D * cfg.n_q_dh + 2 * D * cfg.n_kv_dh + cfg.n_q_dh * D
        n += 2 * D  # norms
        if cfg.qkv_bias:
            n += cfg.n_q_dh + 2 * cfg.n_kv_dh
    elif desc.mixer == "mla":
        m = cfg.mla
        n += D * cfg.n_heads * (m.nope_dim + m.rope_dim)
        n += D * m.kv_lora + D * m.rope_dim + m.kv_lora
        n += m.kv_lora * cfg.n_heads * (m.nope_dim + m.v_dim)
        n += cfg.n_heads * m.v_dim * D + 2 * D
    elif desc.mixer == "mamba":
        md = cfg.mamba
        dims_inner = md.expand * D
        conv_dim = dims_inner + 2 * md.d_state
        H = dims_inner // md.headdim
        n += D * (2 * dims_inner + 2 * md.d_state + H)
        n += md.d_conv * conv_dim + conv_dim + 3 * H + dims_inner
        n += dims_inner * D + 2 * D
    if desc.cross:
        n += D * cfg.n_q_dh + 2 * D * cfg.n_kv_dh + cfg.n_q_dh * D + D
    if desc.mlp == "dense":
        n += 3 * D * F + D
    elif desc.mlp == "moe":
        e = cfg.moe.top_k if active_only else cfg.moe.num_experts
        n += 3 * D * F * e + D * cfg.moe.num_experts
        n += 3 * D * F * cfg.moe.num_shared + D
    return n


def _count_params(cfg: ArchConfig, active_only: bool) -> int:
    prologue, pattern, repeats = layer_plan(cfg)
    n = cfg.vocab * cfg.d_model                       # embedding
    if not cfg.tie_embeddings:
        n += cfg.vocab * cfg.d_model                  # lm head
    n += cfg.d_model                                  # final norm
    for d in prologue:
        n += _block_params(cfg, d, active_only)
    n += repeats * sum(_block_params(cfg, d, active_only) for d in pattern)
    if cfg.enc_dec:
        enc_desc = BlockDesc(mixer="attn", mlp="dense", cross=False)
        n += cfg.enc_layers * _block_params(cfg, enc_desc, active_only)
        n += cfg.d_model
        # decoder cross-attention sublayers
        n += cfg.num_layers * (2 * cfg.d_model * cfg.n_q_dh
                               + 2 * cfg.d_model * cfg.n_kv_dh + cfg.d_model)
    return n


# Convenience accessors used by the counter.
ArchConfig.n_q_dh = property(lambda c: c.n_heads * c.dh)
ArchConfig.n_kv_dh = property(lambda c: c.n_kv_heads * c.dh)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str, **overrides) -> ArchConfig:
    cfg = _REGISTRY[name]
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def list_configs() -> List[str]:
    return sorted(_REGISTRY)
