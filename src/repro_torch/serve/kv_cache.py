"""Slot-based KV-cache management for continuous batching (port of
``repro.serve.kv_cache``).

The engine owns one *batched* cache (as ``TransformerLM.init_cache``
makes it) whose leading dimension is a pool of ``num_slots`` sequence
slots.  Requests are admitted into free slots and retired out of them;
the decode step never changes shape -- the Cavs property (static
program, dynamic occupancy) applied to serving.  Per-slot fill levels
ride along as a ``positions`` vector; the decode kernel masks by
``kv_len`` so dead or fresh slots never reach attention.

The reference finds each leaf's slot axis structurally
(``_slot_axis``: the axis where the pool has ``num_slots`` and the
prefilled cache 1); the port's caches hold one tensor a layer, so the
slot axis is 0 for every leaf.  Admission writes the slot IN PLACE: the
prefilled rows, and zeros over the rest of the slot, the same values the
reference's padded ``dynamic_update_slice`` writes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional

import numpy as np
import torch

Cache = Any


def _walk(fn: Callable[[torch.Tensor, torch.Tensor], None], pool: Cache,
          one: Cache) -> None:
    """``fn(pool_leaf, one_leaf)`` over two caches of one structure
    (nested dicts and lists of tensors)."""
    if isinstance(pool, torch.Tensor):
        fn(pool, one)
    elif isinstance(pool, dict):
        for k in pool:
            _walk(fn, pool[k], one[k])
    else:
        for p, o in zip(pool, one, strict=True):
            _walk(fn, p, o)


@dataclasses.dataclass
class CacheSlots:
    """Host-side occupancy bookkeeping over a device cache."""

    cache: Cache                     # every leaf [slots, ...]
    num_slots: int
    positions: np.ndarray            # [slots] int32 fill level (0 = empty)
    active: np.ndarray               # [slots] bool
    request_of: List[Optional[int]]  # slot -> request id

    @classmethod
    def create(cls, cache: Cache, num_slots: int) -> "CacheSlots":
        return cls(cache=cache, num_slots=num_slots,
                   positions=np.zeros(num_slots, np.int32),
                   active=np.zeros(num_slots, bool),
                   request_of=[None] * num_slots)

    # -- occupancy ---------------------------------------------------------
    def free_slots(self) -> List[int]:
        return [i for i in range(self.num_slots) if not self.active[i]]

    @property
    def num_active(self) -> int:
        return int(self.active.sum())

    # -- admit / retire ------------------------------------------------------
    def admit(self, slot: int, request_id: int, prefill_cache: Cache,
              prompt_len: int) -> None:
        """Copy a single-sequence prefilled cache (every leaf ``[1, ...]``,
        each other dimension at most the pool's) into ``slot``; the rest
        of the slot is zeroed."""
        def write(pool: torch.Tensor, one: torch.Tensor) -> None:
            if (one.dim() != pool.dim() or one.shape[0] != 1
                    or any(o > p for o, p in zip(one.shape[1:],
                                                 pool.shape[1:]))):
                raise ValueError(f"prefilled cache {tuple(one.shape)} does "
                                 f"not fit a slot of {tuple(pool.shape)}")
            dst = pool[slot]
            dst.zero_()
            dst[tuple(slice(0, n) for n in one.shape[1:])] = one[0]

        _walk(write, self.cache, prefill_cache)
        self.positions[slot] = prompt_len
        self.active[slot] = True
        self.request_of[slot] = request_id

    def retire(self, slot: int) -> None:
        self.active[slot] = False
        self.positions[slot] = 0
        self.request_of[slot] = None

    def advance(self) -> None:
        """All active slots consumed one decode step."""
        self.positions[self.active] += 1

    def positions_device(self, device) -> torch.Tensor:
        """The fill levels as an int32 tensor on ``device`` (a copy: the
        host array is mutated between ticks)."""
        return torch.from_numpy(self.positions.copy()).to(device)
