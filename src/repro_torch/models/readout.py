"""Readout heads: the lazy ``push`` consumers of the node-state buffer,
PyTorch port of ``repro.models.readout``.

Cavs collects outputs lazily (§3.5): the scheduler fills the node-state
buffer, and everything downstream — classification over root states,
regression, next-token logits — reads it *after* the sequential region,
batched over however many roots retired together.  The serving engines
call these heads at retirement time (``serve/continuous.py`` retires
finished roots straight into them); training loops call them on
``readout_roots`` output.

  - :class:`ClassificationHead` — root state → class logits, with the
    numerically stable batched softmax/log-softmax below and a mean-NLL
    loss (the Tree-LSTM sentiment setup, paper §5.2);
  - :class:`RegressionHead` — root state → real-valued outputs, MSE;
  - :class:`TokenReadout` — root state → token logits plus a
    sampled-feedback generation loop: sample a token, embed it, and
    advance the SAME arity-1 vertex cell one step, so serving emits
    tokens rather than raw states.

Heads are frozen dataclasses with an explicit ``init(generator)`` and
plain functions of ``(params, tensors)``, like the cells in
``models/rnn.py``; autograd differentiates them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.vertex import apply_unbatched, has_eager_projection
from repro_torch.models.layers import dense_init

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Stable batched softmax (shared numerics)
# ---------------------------------------------------------------------------

def batched_log_softmax(logits: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Max-subtracted log-softmax: finite for logits up to float32 max
    (``exp`` sees only values <= 0) — a blown-up root state must give a
    bad *score*, not a NaN that trips the engine's non-finite guard.  The
    max is held constant under autograd, as the reference's
    ``stop_gradient``."""
    m = torch.amax(logits, dim=dim, keepdim=True).detach()
    shifted = logits - m
    return shifted - torch.log(torch.sum(torch.exp(shifted), dim=dim,
                                         keepdim=True))


def batched_softmax(logits: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Max-subtracted softmax over a batch of logit rows."""
    m = torch.amax(logits, dim=dim, keepdim=True).detach()
    e = torch.exp(logits - m)
    return e / torch.sum(e, dim=dim, keepdim=True)


# ---------------------------------------------------------------------------
# Classification / regression heads
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ClassificationHead:
    """Linear head over root states: ``[K, S] → [K, num_classes]``."""

    state_dim: int
    num_classes: int

    def init(self, generator: torch.Generator, device="cuda") -> Params:
        """Random ``w`` from ``generator`` (drawn on the CPU), zero ``b``,
        both on ``device``."""
        return {"w": dense_init(generator, self.state_dim,
                                self.num_classes).to(device),
                "b": torch.zeros((self.num_classes,), dtype=torch.float32,
                                 device=device)}

    def logits(self, params: Params, roots: torch.Tensor) -> torch.Tensor:
        return roots @ params["w"] + params["b"]

    def log_probs(self, params: Params, roots: torch.Tensor) -> torch.Tensor:
        return batched_log_softmax(self.logits(params, roots))

    def probs(self, params: Params, roots: torch.Tensor) -> torch.Tensor:
        return batched_softmax(self.logits(params, roots))

    def predict(self, params: Params, roots: torch.Tensor) -> torch.Tensor:
        return torch.argmax(self.logits(params, roots), dim=-1)

    def loss(self, params: Params, roots: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
        """Mean negative log-likelihood of ``labels`` (``[K]`` ints)."""
        lp = self.log_probs(params, roots)
        return -torch.mean(torch.gather(lp, 1, labels.long()[:, None])[:, 0])


@dataclasses.dataclass(frozen=True)
class RegressionHead:
    """Linear regression head over root states: ``[K, S] → [K, out_dim]``."""

    state_dim: int
    out_dim: int = 1

    def init(self, generator: torch.Generator, device="cuda") -> Params:
        return {"w": dense_init(generator, self.state_dim,
                                self.out_dim).to(device),
                "b": torch.zeros((self.out_dim,), dtype=torch.float32,
                                 device=device)}

    def predict(self, params: Params, roots: torch.Tensor) -> torch.Tensor:
        return roots @ params["w"] + params["b"]

    def loss(self, params: Params, roots: torch.Tensor,
             targets: torch.Tensor) -> torch.Tensor:
        d = self.predict(params, roots) - targets
        return torch.mean(d * d)


# ---------------------------------------------------------------------------
# Token readout: sampled-feedback generation through the vertex cell
# ---------------------------------------------------------------------------

Key = Union[int, Sequence[int]]


def step_generator(key: Key, t: int) -> torch.Generator:
    """The CPU generator that samples step ``t`` under ``key`` (an int or
    a tuple of non-negative ints, e.g. ``(seed, request_id)``): seeded
    from ``(*key, t)`` alone, so a step's draw never depends on what
    else ran before it."""
    keys = (key,) if isinstance(key, (int, np.integer)) else tuple(key)
    seed = np.random.SeedSequence([int(k) for k in keys] + [int(t)]) \
        .generate_state(1)[0]
    return torch.Generator().manual_seed(int(seed))


def _sample(logits: torch.Tensor, generator: torch.Generator) -> int:
    """One categorical draw from ``logits`` ``[vocab]``, by Gumbel-max
    on the CPU: ``argmax(logits - log(-log(U)))`` with ``U`` uniform from
    ``generator``."""
    u = torch.rand(logits.shape[-1], generator=generator,
                   dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u))
    return int(torch.argmax(logits.detach().float().cpu() + gumbel))


def _feed(cell, head_params: Params, cell_params: Params,
          state: torch.Tensor, tok: int) -> torch.Tensor:
    """Embed token ``tok`` and advance ``cell`` one arity-1 step from
    ``state`` ``[S]``; returns the new state."""
    raw = head_params["embed"][tok]
    ext = raw
    if has_eager_projection(cell):
        ext = cell.project_inputs(cell_params, raw[None])[0]
    ones = torch.ones((1,), dtype=state.dtype, device=state.device)
    return apply_unbatched(cell, cell_params, state[None, :], ones,
                           ext).state


def _gen_step(cell, head_params: Params, cell_params: Params,
              state: torch.Tensor, generator: torch.Generator
              ) -> Tuple[int, torch.Tensor]:
    """One sampled-feedback step: state → logits → sampled token →
    embed → one arity-1 cell application."""
    logits = state @ head_params["w"] + head_params["b"]
    tok = _sample(logits, generator)
    return tok, _feed(cell, head_params, cell_params, state, tok)


@dataclasses.dataclass(frozen=True)
class TokenReadout:
    """Next-token head + generation loop over an arity-1 vertex cell.

    ``cell`` is the SAME vertex function that scored the structure (its
    state feeds straight back in — no re-encode), ``vocab`` the output
    vocabulary.  ``generate`` runs the sampled-feedback loop: logits from
    the current state, a categorical draw, embed, one cell step; it stops
    at ``eos_id`` or ``max_tokens``.
    """

    cell: Any                        # arity-1 vertex function
    vocab: int
    eos_id: Optional[int] = None

    def __post_init__(self):
        if getattr(self.cell, "arity", None) != 1:
            raise ValueError(
                f"TokenReadout feeds sampled tokens back through an "
                f"arity-1 cell; {type(self.cell).__name__} has arity "
                f"{getattr(self.cell, 'arity', None)}")

    def init(self, generator: torch.Generator, device="cuda") -> Params:
        """``w`` ``[S, vocab]``, zero ``b`` and the token embedding
        ``embed`` ``[vocab, input_dim]``, drawn from ``generator`` on the
        CPU, on ``device``."""
        w = dense_init(generator, self.cell.state_dim, self.vocab)
        embed = dense_init(generator, self.vocab, self.cell.input_dim)
        return {"w": w.to(device),
                "b": torch.zeros((self.vocab,), dtype=torch.float32,
                                 device=device),
                "embed": embed.to(device)}

    def logits(self, params: Params, states: torch.Tensor) -> torch.Tensor:
        """Batched next-token logits: ``[K, S] → [K, vocab]``."""
        return states @ params["w"] + params["b"]

    def generate(self, params: Params, cell_params: Params, state,
                 key: Key, *, max_tokens: int = 16,
                 eos_id: Optional[int] = None) -> List[int]:
        """Sample up to ``max_tokens`` tokens from ``state`` (``[S]``, a
        tensor or an array; computed on the device of ``params``).

        ``jax.random.categorical`` cannot be reproduced here, so the
        draws differ from the reference's; the contract is the
        reference's: step ``t`` samples from the CPU generator seeded
        from ``(*key, t)`` (:func:`step_generator`), so the tokens depend
        on ``(params, cell_params, state, key)`` only.  A caller that
        keys each request by ``(seed, request_id)`` (the continuous
        engine does) gets the same tokens however requests interleave.
        """
        eos = self.eos_id if eos_id is None else eos_id
        device = params["w"].device
        state = torch.as_tensor(state, dtype=torch.float32).to(device)
        toks: List[int] = []
        with torch.no_grad():
            for t in range(max_tokens):
                tok, state = _gen_step(self.cell, params, cell_params, state,
                                       step_generator(key, t))
                toks.append(tok)
                if eos is not None and tok == eos:
                    break
        return toks
