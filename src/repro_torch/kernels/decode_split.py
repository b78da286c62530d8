"""K11's split of a slot's cache rows over a thread-block cluster.

``csrc/decode_attention.cu`` splits each slot's valid rows ``[lo, len)``
over the ``ns`` CTAs of a cluster and combines their partial softmax
statistics in rank order.  The arithmetic of that split is written here
once and mirrored in the ``.cu`` (``heads_per_cta``, ``row_share``): the
wrapper (:mod:`repro_torch.kernels.decode_attention`) picks ``ns`` with
:func:`split_count`, and ``ref.decode_attention_split`` assigns rows with
:func:`row_range` and :func:`split_rows`, so the CPU tests check the very
assignment the kernel uses.  No imports: the plain reference and the
wrapper both depend on this module, and it on nothing.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

#: CTAs a cluster at most (the portable cluster size).
MAX_SPLITS = 8
#: A cache of at most this many rows is not split (``ns`` 1).
SHORT_CACHE = 64
#: Rows a split's share is rounded up to.
SHARE_ROWS = 8


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def heads_per_cta(G: int) -> int:
    """Query heads of one GQA group that a cluster serves (GC); a larger
    group takes ``ceil(G / GC)`` clusters."""
    return 1 if G == 1 else (4 if G <= 4 else 8)


def split_count(S: int, clusters: int, sms: int) -> int:
    """CTAs a cluster (NS), from the static shape alone: 1 for a short
    cache (``S <= 64``), else the largest power of two, at most 8, that
    keeps ``clusters * ns <= 2 * sms`` (at least 1): every CTA of the
    launch resident at once (granite's 64 clusters on 132 SMs: 4, 256
    CTAs)."""
    if S <= SHORT_CACHE:
        return 1
    ns = 1
    while ns < MAX_SPLITS and clusters * ns * 2 <= 2 * sms:
        ns *= 2
    return ns


def row_range(kv_len: int, S: int, window: Optional[int]) -> Tuple[int, int]:
    """The valid rows ``[lo, hi)`` of a slot: ``lo = max(0, kv_len -
    window)`` under a window (else 0), ``hi = min(kv_len, S)``, and
    ``hi >= lo`` (an empty range where nothing is valid)."""
    lo = max(0, kv_len - window) if window else 0
    return lo, max(lo, min(kv_len, S))


def split_rows(lo: int, hi: int, ns: int) -> List[Tuple[int, int]]:
    """Rank ``r``'s rows ``[lo + r c, lo + (r + 1) c)`` cut at ``hi``, for
    ``r`` in ``0..ns-1``: ``c = ceil((hi - lo) / ns)`` rounded up to 8."""
    c = _cdiv(_cdiv(hi - lo, ns), SHARE_ROWS) * SHARE_ROWS
    return [(min(lo + r * c, hi), min(lo + (r + 1) * c, hi))
            for r in range(ns)]
