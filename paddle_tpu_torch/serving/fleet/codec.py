"""Wire codec for the fleet data plane (the port of
``paddle_tpu/serving/fleet/codec.py``): raw-buffer array framing.

The router forwards request batches to replica workers over plain
HTTP; the payload is numpy arrays. JSON-of-nested-lists would burn the
router's single thread-pool CPU on float formatting, and pickle would
widen the trusted surface to every socket peer — so the wire format is a minimal explicit framing of
``(dtype, shape, raw C-contiguous bytes)``, decodable with
``np.frombuffer`` and nothing else. Only shapes/dtypes/bytes cross the
wire; nothing on the decode path executes content.

Layout (all integers little-endian):

- array:    u8 dtype-str length, dtype.str ascii, u8 ndim,
            u32 x ndim dims, u64 nbytes, raw buffer. Every standard
            numpy dtype is written as the reference writes it, byte for
            byte. ``ml_dtypes.bfloat16`` (a bf16 Predictor's outputs) goes
            out under its name ``bfloat16`` and decodes back to bfloat16;
            its ``dtype.str``, ``'<V2'``, which the reference writes,
            would reach the peer as raw two-byte voids.
- batch:    magic ``PDFB``, u32 n_requests, per request
            (u32 n_feeds, n_feeds arrays)
- results:  magic ``PDFR``, u32 n_requests, per request u8 status —
            0 = ok (u32 n_outputs, arrays) or an error code
            (u32 utf-8 length, message) mapping back to the serving
            exception types, so ``QueueFullError`` raised in a replica
            process is ``QueueFullError`` again out of the router.
- trace trailer (optional): magic ``PDTC`` appended AFTER a batch's
            last request — u32 n_requests, per request u16 length +
            ascii ``traceparent`` (0 = untraced). Append-only, so the
            router can stamp trace contexts onto an opaque client
            body without decoding the arrays, and a decoder that
            ignores it (``decode_batch``) keeps working unchanged.
- deadline trailer (optional): magic ``PDDL`` — u32 n_requests, per
            request f64 REMAINING budget milliseconds (NaN =
            unbounded). Relative-not-absolute because router and
            worker wall clocks are not comparable; each hop deducts
            its own elapsed time before re-stamping. Trailers may
            appear in any order after the batch body; every section
            must parse to exactly EOF.
- tenant trailer (optional): magic ``PDTN`` — u32 n_requests, per
            request u16 length + ascii tenant id (0 = untagged; the
            consumer maps untagged to the ``default`` tenant). Same
            append-only / upstream-stamp-wins discipline as PDTC, so
            a client that tagged its own tenancy is never relabeled
            by the router.
"""
from __future__ import annotations

import math
import re
import struct
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from ..request import (DeadlineExceededError, QueueFullError,
                       QuotaExceededError, ServerClosedError)
from .resilience import ReplicaWedgedError

__all__ = [
    "encode_batch", "decode_batch", "decode_batch_ex",
    "decode_batch_trailers", "decode_batch_trailers_ex",
    "encode_results", "decode_results",
    "peek_batch_size", "attach_trace_trailer",
    "attach_deadline_trailer", "attach_tenant_trailer", "CodecError",
    "BATCH_MAGIC", "RESULTS_MAGIC", "TRACE_MAGIC", "DEADLINE_MAGIC",
    "TENANT_MAGIC", "BFLOAT16_TAG",
]

BATCH_MAGIC = b"PDFB"
RESULTS_MAGIC = b"PDFR"
TRACE_MAGIC = b"PDTC"
DEADLINE_MAGIC = b"PDDL"
TENANT_MAGIC = b"PDTN"
# the dtype tag of an ml_dtypes bfloat16 array (see the module docstring)
BFLOAT16_TAG = b"bfloat16"

# status codes for per-request results (0 = ok)
_OK = 0
_ERR_GENERIC = 1
_ERR_QUEUE_FULL = 2
_ERR_DEADLINE = 3
_ERR_CLOSED = 4
_ERR_WEDGED = 5
_ERR_QUOTA = 6

# QuotaExceededError subclasses QueueFullError, so _CODE_OF must map
# the SUBCLASS first-match by exact type (dict lookup is exact) — a
# quota shed crosses the wire as _ERR_QUOTA, not _ERR_QUEUE_FULL.
_CODE_OF = {QueueFullError: _ERR_QUEUE_FULL,
            QuotaExceededError: _ERR_QUOTA,
            DeadlineExceededError: _ERR_DEADLINE,
            ServerClosedError: _ERR_CLOSED,
            ReplicaWedgedError: _ERR_WEDGED}
_EXC_OF: Dict[int, type] = {_ERR_QUEUE_FULL: QueueFullError,
                            _ERR_QUOTA: QuotaExceededError,
                            _ERR_DEADLINE: DeadlineExceededError,
                            _ERR_CLOSED: ServerClosedError,
                            _ERR_WEDGED: ReplicaWedgedError,
                            _ERR_GENERIC: RuntimeError}


class CodecError(ValueError):
    """Malformed fleet wire payload."""


def _bfloat16():
    """``ml_dtypes.bfloat16``, or None where ``ml_dtypes`` does not import
    (then no array of that type can exist to encode)."""
    try:
        import ml_dtypes
    except ImportError:
        return None
    return np.dtype(ml_dtypes.bfloat16)


def _dtype_tag(dtype: np.dtype) -> bytes:
    if dtype.kind == "V" and dtype == _bfloat16():
        return BFLOAT16_TAG
    return dtype.str.encode("ascii")


def _parse_dtype(tag: bytes) -> np.dtype:
    if tag == BFLOAT16_TAG:
        bf16 = _bfloat16()
        if bf16 is None:
            raise CodecError("a bfloat16 array needs ml_dtypes to decode")
        return bf16
    return np.dtype(tag.decode("ascii"))


def _put_array(parts: List[bytes], a: np.ndarray):
    a = np.ascontiguousarray(a)
    ds = _dtype_tag(a.dtype)
    parts.append(struct.pack("<B", len(ds)))
    parts.append(ds)
    parts.append(struct.pack("<B", a.ndim))
    parts.append(struct.pack(f"<{a.ndim}I", *a.shape)
                 if a.ndim else b"")
    parts.append(struct.pack("<Q", a.nbytes))
    parts.append(a.tobytes())


class _Reader:
    __slots__ = ("data", "ofs")

    def __init__(self, data: bytes):
        self.data = data
        self.ofs = 0

    def take(self, n: int) -> bytes:
        if self.ofs + n > len(self.data):
            raise CodecError("truncated fleet payload")
        out = self.data[self.ofs:self.ofs + n]
        self.ofs += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def array(self) -> np.ndarray:
        dtype = _parse_dtype(self.take(self.u8()))
        ndim = self.u8()
        shape = struct.unpack(f"<{ndim}I", self.take(4 * ndim)) \
            if ndim else ()
        nbytes = self.u64()
        want = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize \
            if ndim else dtype.itemsize
        if nbytes != want:
            raise CodecError(
                f"array payload {nbytes}B != shape/dtype size {want}B")
        buf = self.take(nbytes)
        return np.frombuffer(buf, dtype=dtype).reshape(shape)


def encode_batch(feeds_list: Sequence[Sequence[np.ndarray]]) -> bytes:
    """Encode a ``submit_many`` batch: a list of per-request feed
    lists (each ordered like the model's feed names)."""
    parts: List[bytes] = [BATCH_MAGIC,
                          struct.pack("<I", len(feeds_list))]
    for feeds in feeds_list:
        parts.append(struct.pack("<I", len(feeds)))
        for a in feeds:
            _put_array(parts, np.asarray(a))
    return b"".join(parts)


def peek_batch_size(data: bytes) -> int:
    """Request count of an encoded batch without decoding the arrays —
    the router's pass-through path needs only this for accounting."""
    if len(data) < 8 or data[:4] != BATCH_MAGIC:
        raise CodecError("not a fleet batch payload")
    return struct.unpack("<I", data[4:8])[0]


def decode_batch(data: bytes) -> List[List[np.ndarray]]:
    r = _Reader(data)
    if r.take(4) != BATCH_MAGIC:
        raise CodecError("not a fleet batch payload")
    return [[r.array() for _ in range(r.u32())]
            for _ in range(r.u32())]


def _parse_trace_section(r: "_Reader", n_req: int):
    n = r.u32()
    if n != n_req:
        raise CodecError(
            f"trace trailer for {n} requests on a batch of {n_req}")
    out = []
    for _ in range(n):
        ln = struct.unpack("<H", r.take(2))[0]
        out.append(r.take(ln).decode("ascii", "replace")
                   if ln else None)
    return out


def _parse_deadline_section(r: "_Reader", n_req: int):
    n = r.u32()
    if n != n_req:
        raise CodecError(
            f"deadline trailer for {n} requests on a batch of {n_req}")
    out = []
    for _ in range(n):
        ms = struct.unpack("<d", r.take(8))[0]
        out.append(None if math.isnan(ms) else float(ms))
    return out


def _parse_tenant_section(r: "_Reader", n_req: int):
    n = r.u32()
    if n != n_req:
        raise CodecError(
            f"tenant trailer for {n} requests on a batch of {n_req}")
    out = []
    for _ in range(n):
        ln = struct.unpack("<H", r.take(2))[0]
        out.append(r.take(ln).decode("ascii", "replace")
                   if ln else None)
    return out


_SECTION_PARSERS = {TRACE_MAGIC: _parse_trace_section,
                    DEADLINE_MAGIC: _parse_deadline_section,
                    TENANT_MAGIC: _parse_tenant_section}


def _walk_sections(r: "_Reader", n_req: int) -> Dict[bytes, list]:
    """Parse the optional trailer sections (any order) to exactly EOF.
    An unknown magic is a malformed payload, not a skippable blob —
    sections carry no length prefix, so skipping is impossible."""
    sections: Dict[bytes, list] = {}
    while r.ofs < len(r.data):
        magic = r.take(4)
        parser = _SECTION_PARSERS.get(magic)
        if parser is None:
            raise CodecError(
                f"unknown trailer section magic {magic!r}")
        if magic in sections:
            raise CodecError(
                f"duplicate trailer section {magic!r}")
        sections[magic] = parser(r, n_req)
    return sections


def _has_section(data: bytes, magic: bytes) -> bool:
    """Whether an intact payload already carries a ``magic`` trailer
    section (malformed trailers report False — the caller's append
    will fail loudly at decode, never silently double-stamp)."""
    idx = data.rfind(magic)
    if idx < 8:          # before any possible batch body
        return False
    try:
        n_req = peek_batch_size(data)
        r = _Reader(data)
        r.ofs = idx
        return magic in _walk_sections(r, n_req)
    except (CodecError, struct.error):
        return False


def attach_trace_trailer(
        data: bytes,
        traceparents: Sequence[Optional[str]]) -> bytes:
    """Append per-request ``traceparent`` headers to an ALREADY
    ENCODED batch (the router's pass-through path never decodes the
    arrays). A payload that already carries a trace trailer is
    returned unchanged — a client that stamped its own trace
    identities wins over the router's."""
    n = peek_batch_size(data)
    if len(traceparents) != n:
        raise CodecError(
            f"trace trailer carries {len(traceparents)} entries for "
            f"a batch of {n} requests")
    if _has_section(data, TRACE_MAGIC):
        return data
    parts: List[bytes] = [data, TRACE_MAGIC, struct.pack("<I", n)]
    for tp in traceparents:
        b = (tp or "").encode("ascii", "replace")
        parts.append(struct.pack("<H", len(b)))
        parts.append(b)
    return b"".join(parts)


def attach_deadline_trailer(
        data: bytes,
        deadlines_ms: Sequence[Optional[float]]) -> bytes:
    """Append per-request REMAINING deadline budgets (ms) to an
    already-encoded batch. ``None`` = unbounded (NaN on the wire).
    Like the trace trailer, a payload that already carries one is
    returned unchanged — the upstream stamp (an external client that
    budgeted its own hops) wins over the router's."""
    n = peek_batch_size(data)
    if len(deadlines_ms) != n:
        raise CodecError(
            f"deadline trailer carries {len(deadlines_ms)} entries "
            f"for a batch of {n} requests")
    if _has_section(data, DEADLINE_MAGIC):
        return data
    parts: List[bytes] = [data, DEADLINE_MAGIC, struct.pack("<I", n)]
    for ms in deadlines_ms:
        parts.append(struct.pack(
            "<d", float("nan") if ms is None else float(ms)))
    return b"".join(parts)


def attach_tenant_trailer(
        data: bytes,
        tenants: Sequence[Optional[str]]) -> bytes:
    """Append per-request tenant ids to an already-encoded batch.
    ``None`` = untagged (0-length on the wire; the consumer maps it to
    the ``default`` tenant). A payload already carrying a tenant
    trailer is returned unchanged — a client that tagged its own
    tenancy wins over the router's header-derived stamp."""
    n = peek_batch_size(data)
    if len(tenants) != n:
        raise CodecError(
            f"tenant trailer carries {len(tenants)} entries for "
            f"a batch of {n} requests")
    if _has_section(data, TENANT_MAGIC):
        return data
    parts: List[bytes] = [data, TENANT_MAGIC, struct.pack("<I", n)]
    for t in tenants:
        b = (t or "").encode("ascii", "replace")
        parts.append(struct.pack("<H", len(b)))
        parts.append(b)
    return b"".join(parts)


def decode_batch_trailers_ex(data: bytes) -> tuple:
    """``(feeds_list, traceparents, deadlines_ms, tenants)`` — the
    full worker-side decode. Each trailer slot is None when the
    payload carries no such section, else one ``Optional`` entry per
    request."""
    r = _Reader(data)
    if r.take(4) != BATCH_MAGIC:
        raise CodecError("not a fleet batch payload")
    feeds = [[r.array() for _ in range(r.u32())]
             for _ in range(r.u32())]
    sections = _walk_sections(r, len(feeds))
    return (feeds, sections.get(TRACE_MAGIC),
            sections.get(DEADLINE_MAGIC),
            sections.get(TENANT_MAGIC))


def decode_batch_trailers(data: bytes) -> tuple:
    """``(feeds_list, traceparents, deadlines_ms)`` — the pre-tenant
    decode shape, kept for callers that do not consume tenancy (the
    ``decode_batch_ex`` back-compat pattern, one generation later)."""
    feeds, traceparents, deadlines, _ = decode_batch_trailers_ex(data)
    return feeds, traceparents, deadlines


def decode_batch_ex(
        data: bytes
) -> tuple:
    """``(feeds_list, traceparents)`` — the pre-deadline decode shape,
    kept for callers that do not consume budgets."""
    feeds, traceparents, _ = decode_batch_trailers(data)
    return feeds, traceparents


def encode_results(
        results: Sequence[Union[Sequence[np.ndarray], BaseException]]
) -> bytes:
    """Encode per-request outcomes: each entry is either the request's
    output-array list or the exception that failed it (only that
    request — a replica-side fault barrier maps per request)."""
    parts: List[bytes] = [RESULTS_MAGIC,
                          struct.pack("<I", len(results))]
    for res in results:
        if isinstance(res, BaseException):
            code = _CODE_OF.get(type(res), _ERR_GENERIC)
            msg = f"{type(res).__name__}: {res}".encode(
                "utf-8", "replace")
            parts.append(struct.pack("<BI", code, len(msg)))
            parts.append(msg)
        else:
            parts.append(struct.pack("<BI", _OK, len(res)))
            for a in res:
                _put_array(parts, np.asarray(a))
    return b"".join(parts)


def decode_results(
        data: bytes
) -> List[Union[List[np.ndarray], BaseException]]:
    r = _Reader(data)
    if r.take(4) != RESULTS_MAGIC:
        raise CodecError("not a fleet results payload")
    out: List[Union[List[np.ndarray], BaseException]] = []
    for _ in range(r.u32()):
        status = r.u8()
        n = r.u32()
        if status == _OK:
            out.append([r.array() for _ in range(n)])
        else:
            msg = r.take(n).decode("utf-8", "replace")
            if status == _ERR_QUOTA:
                # re-typed with its tenant: admit() phrases the
                # message as "tenant '<name>' exceeded ...", so the
                # per-tenant identity survives the wire without a
                # second framing field
                exc = QuotaExceededError(msg)
                m = re.search(r"tenant '([^']+)'", msg)
                if m:
                    exc.tenant = m.group(1)
                out.append(exc)
            else:
                out.append(_EXC_OF.get(status, RuntimeError)(msg))
    return out
