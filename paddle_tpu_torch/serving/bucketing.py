"""Shape bucketing for the prefill windows (the port of the bucket selection
in ``paddle_tpu/serving/bucketing.py``).

Prefill groups run at a (pow2 rows, sequence bucket) shape: rows round up
to the next power of two (capped at ``max_batch_size``) and the window
length up to the next configured bucket. The reference needed this to bound
XLA recompiles; the port keeps it so both engines batch the same requests
into the same padded windows (and a later compiled or graph-captured path
has a bounded shape set).
"""
from __future__ import annotations

from typing import Optional, Sequence

__all__ = ["next_pow2", "ShapeBucketPolicy"]


def next_pow2(n: int) -> int:
    if n <= 1:
        return 1
    return 1 << (int(n - 1).bit_length())


class ShapeBucketPolicy:
    """``bucket_batch(rows)`` / ``bucket_seq(length)`` over a row cap and
    an ascending list of sequence buckets (None: no sequence padding)."""

    def __init__(self, max_batch_size: int = 8, pad_batch: bool = True,
                 seq_buckets: Optional[Sequence[int]] = None):
        self.max_batch_size = int(max_batch_size)
        self.pad_batch = pad_batch
        self.seq_buckets = sorted(int(s) for s in seq_buckets) \
            if seq_buckets else None

    def bucket_batch(self, rows: int) -> int:
        if not self.pad_batch:
            return rows
        return min(next_pow2(rows), self.max_batch_size)

    def bucket_seq(self, length: int) -> int:
        if self.seq_buckets is None:
            return length
        for b in self.seq_buckets:
            if b >= length:
                return b
        # beyond the largest bucket: round to next_pow2
        return next_pow2(length)
