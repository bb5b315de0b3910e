"""Shape bucketing (the port of ``paddle_tpu/serving/bucketing.py``).

Requests run at a (pow2 rows, sequence bucket) shape: batch rows round up to
the next power of two (capped at ``max_batch_size``) and a designated
sequence axis rounds up to the next configured bucket, both zero-padded;
outputs are sliced back to the request's real rows and length on fetch. The
reference needed this to bound XLA recompiles. On the card it bounds the set
of shapes a server runs, which ``warmup`` runs once each: the kernels' first
launches, the caching allocator's pools and cuBLAS's choices. The generation
engine batches its prefill windows with the same policy, so both packages
pad the same requests into the same windows.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["next_pow2", "BucketSpec", "ShapeBucketPolicy"]


def next_pow2(n: int) -> int:
    if n <= 1:
        return 1
    return 1 << (int(n - 1).bit_length())


class BucketSpec:
    """One warmup target: a (batch_bucket, seq_bucket) pair. ``seq`` is
    None for models without a bucketed sequence axis."""

    __slots__ = ("batch", "seq")

    def __init__(self, batch: int, seq: Optional[int] = None):
        self.batch = int(batch)
        self.seq = None if seq is None else int(seq)

    def __repr__(self):
        return f"BucketSpec(batch={self.batch}, seq={self.seq})"


class ShapeBucketPolicy:
    """Quantize request shapes onto the bucket lattice and pad/unpad.

    - ``max_batch_size``: batch buckets are the powers of two up to this
      cap (``pad_batch=False``: each coalesced batch runs at its exact row
      count).
    - ``seq_buckets``: ascending bucket lengths for the sequence axis, or
      None for no sequence padding (padding assumes that zero positions do
      not perturb the real ones, or that the caller compares against the
      padded request).
    - ``seq_axis``: the sequence axis of each feed (feeds with ndim <=
      seq_axis are left untouched).
    """

    def __init__(self, max_batch_size: int = 8, pad_batch: bool = True,
                 seq_buckets: Optional[Sequence[int]] = None,
                 seq_axis: int = 1):
        self.max_batch_size = int(max_batch_size)
        self.pad_batch = pad_batch
        self.seq_buckets = sorted(int(s) for s in seq_buckets) \
            if seq_buckets else None
        self.seq_axis = int(seq_axis)

    # ---- bucket selection ----
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

    # ---- request signature (grouping key for the batcher) ----
    def signature(self, feeds: List[np.ndarray]) -> Tuple:
        """Hashable compatibility key: two requests may share one device
        batch iff their per-feed dtypes and non-batch shapes (after
        sequence bucketing) are identical; the dtype as numpy's
        ``dtype.str`` ('<f4')."""
        sig = []
        for a in feeds:
            shape = list(a.shape[1:])  # drop the batch axis
            ax = self.seq_axis - 1     # seq axis within the rest
            if self.seq_buckets is not None and 0 <= ax < len(shape):
                shape[ax] = self.bucket_seq(shape[ax])
            sig.append((a.dtype.str, tuple(shape)))
        return tuple(sig)

    # ---- padding ----
    def pad_request_seq(self, feeds: List[np.ndarray]) -> List[np.ndarray]:
        """Zero-pad each feed's sequence axis up to its bucket."""
        if self.seq_buckets is None:
            return feeds
        out = []
        for a in feeds:
            if a.ndim > self.seq_axis:
                cur = a.shape[self.seq_axis]
                tgt = self.bucket_seq(cur)
                if tgt != cur:
                    pad = [(0, 0)] * a.ndim
                    pad[self.seq_axis] = (0, tgt - cur)
                    a = np.pad(a, pad)
            out.append(a)
        return out

    def pad_rows(self, arr: np.ndarray, target_rows: int) -> np.ndarray:
        """Zero-pad axis 0 up to ``target_rows``."""
        cur = arr.shape[0]
        if cur == target_rows:
            return arr
        pad = [(0, 0)] * arr.ndim
        pad[0] = (0, target_rows - cur)
        return np.pad(arr, pad)

    # ---- unpadding ----
    def unpad_output(self, out: np.ndarray, orig_seq: Optional[int]):
        """Slice a per-request output back to the request's real sequence
        length, when it still carries the padded extent at ``seq_axis``
        (outputs that reduced the sequence away pass through)."""
        if self.seq_buckets is None or orig_seq is None:
            return out
        ax = self.seq_axis
        if out.ndim > ax and out.shape[ax] == self.bucket_seq(orig_seq) \
                and out.shape[ax] != orig_seq:
            idx = [slice(None)] * out.ndim
            idx[ax] = slice(0, orig_seq)
            return out[tuple(idx)]
        return out

    @staticmethod
    def elements_per_row(sig: Tuple) -> int:
        """Input elements one (padded) batch row carries under this
        signature (the padding-waste unit of the metrics)."""
        return sum(int(np.prod(shape)) if shape else 1 for _, shape in sig)
