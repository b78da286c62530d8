"""Shape buckets (stage 3 of the schedule pipeline), port of
``repro.pipeline.buckets``.

A tightly packed schedule has data-dependent dims ``(T, M, A, N)``.
In the JAX package every new combination is a new XLA program — the
recompilation tax Cavs exists to avoid; here it is a new set of launch
shapes (and, once the level loop is captured, a new CUDA graph).
:class:`BucketPolicy` quantizes the tight dims of each minibatch UP to
bucket boundaries and feeds them to ``pack_batch``'s ``pad_*``
parameters, so near-miss batches land in the same bucket.  Padding
waste is bounded by the rounding granule (occupancy stays
``> tight/(tight+round)`` per dim).

Unlike ``repro.core.structure.fit_bucket`` (one worst-case bucket
derived from a whole corpus up front), the policy needs no corpus scan:
it quantizes whatever batch arrives, trading a handful of shapes (one
per populated bucket) for zero prior knowledge — the right shape for
serving and streaming training.

:class:`ShapeCensus` counts the distinct padded shape tuples actually
produced (the compile-count metric of the JAX package).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

from repro_torch.core.structure import InputGraph, LevelSchedule, tight_dims


class PadDims(NamedTuple):
    """``pack_batch``'s four pad parameters, as one value.  ``None`` in a
    slot means "tight" for that dim."""

    levels: Optional[int]
    width: Optional[int]
    arity: Optional[int]
    nodes: Optional[int]


#: Fully tight packing (no bucketing).
TIGHT = PadDims(None, None, None, None)


def _round_multiple(x: int, r: int) -> int:
    return max(r, (x + r - 1) // r * r)


def _round_pow2(x: int, floor: int) -> int:
    return max(floor, 1 << (max(x, 1) - 1).bit_length())


@dataclasses.dataclass(frozen=True)
class BucketPolicy:
    """Quantize tight ``(T, M, A, N)`` to bucket boundaries.

    ``mode="multiple"`` rounds each dim up to the next multiple of its
    granule (linear bucket ladder, bounded waste); ``mode="pow2"``
    rounds to the next power of two (log-many buckets total — the
    serving default, mirroring the prompt-length buckets of
    ``ServeEngine``).  ``round_arity`` defaults to 1 (exact): fixed-
    arity cells (Tree-FC's concat weight) require the packed ``A`` to
    equal ``spec.arity``, so arity is never padded speculatively.
    """

    round_levels: int = 8
    round_width: int = 8
    round_nodes: int = 16
    round_arity: int = 1
    mode: str = "multiple"

    def __post_init__(self) -> None:
        if self.mode not in ("multiple", "pow2"):
            raise ValueError(
                f"BucketPolicy mode must be 'multiple' or 'pow2', "
                f"got {self.mode!r}")
        for name in ("round_levels", "round_width", "round_nodes",
                     "round_arity"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1")

    # -- quantization -----------------------------------------------------
    def quantize(self, t: int, m: int, a: int, n: int) -> PadDims:
        """Bucket boundaries for one batch's tight dims."""
        if self.mode == "pow2":
            return PadDims(
                levels=_round_pow2(t, self.round_levels),
                width=_round_pow2(m, self.round_width),
                arity=_round_multiple(a, self.round_arity),
                nodes=_round_pow2(n, self.round_nodes))
        return PadDims(
            levels=_round_multiple(t, self.round_levels),
            width=_round_multiple(m, self.round_width),
            arity=_round_multiple(a, self.round_arity),
            nodes=_round_multiple(n, self.round_nodes))

    def bucket(self, graphs: Sequence[InputGraph]) -> PadDims:
        """The bucket covering one minibatch: tight dims (the same ones
        ``pack_batch`` derives — shared ``structure.tight_dims``)
        quantized up."""
        t, m, a, n = tight_dims(graphs)
        return self.quantize(t, m, a, n)


class ShapeCensus:
    """Distinct padded shapes actually produced — the compile-count
    metric.  The bucket policy's job is to keep :attr:`num_shapes` flat
    while :attr:`num_batches` grows."""

    def __init__(self) -> None:
        self._counts: Dict[Tuple[int, int, int, int], int] = {}
        self.num_batches = 0

    def record(self, sched: LevelSchedule) -> Tuple[int, int, int, int]:
        key = (sched.T, sched.M, sched.A, sched.N)
        self._counts[key] = self._counts.get(key, 0) + 1
        self.num_batches += 1
        return key

    @property
    def num_shapes(self) -> int:
        return len(self._counts)

    def counts(self) -> Dict[Tuple[int, int, int, int], int]:
        """Batches packed per distinct ``(T, M, A, N)`` shape."""
        return dict(self._counts)

    def summary(self) -> Dict[str, int]:
        return {"batches": self.num_batches, "shapes": self.num_shapes}
