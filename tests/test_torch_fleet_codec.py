"""The port's fleet wire codec (``paddle_tpu_torch.serving.fleet.codec``)
against ``paddle_tpu``'s, byte for byte.

Every encoder gets the same payloads in both packages (float32, float16,
int8/32/64, bool, empty and 0-d arrays, ragged batches, typed errors, the trace,
deadline and tenant trailers) and must write the same bytes; each package
decodes the other's bytes to the same arrays (dtype, shape and values
exactly) and to its own exception types; malformed payloads raise each
package's ``CodecError`` alike. bfloat16 is the one deliberate difference:
the port writes ``ml_dtypes.bfloat16`` under the tag ``bfloat16`` and
decodes it back to bfloat16, where the reference writes its ``dtype.str``
(``'<V2'``) and hands the peer raw two-byte voids (pinned here).
"""
import ml_dtypes
import numpy as np
import pytest

from paddle_tpu.serving import request as jreq
from paddle_tpu.serving.fleet import codec as jcodec
from paddle_tpu.serving.fleet import resilience as jres
from paddle_tpu_torch.serving import request as preq
from paddle_tpu_torch.serving.fleet import codec as pcodec
from paddle_tpu_torch.serving.fleet import resilience as pres

DTYPES = ("float32", "float16", "int8", "int32", "int64", "bool", "uint8",
          "float64")


def _arr(dtype, shape, seed):
    rng = np.random.RandomState(seed)
    if dtype == "bool":
        return rng.rand(*shape) > 0.5
    if np.dtype(dtype).kind == "f":
        return rng.randn(*shape).astype(dtype)
    info = np.iinfo(dtype)
    return rng.randint(max(info.min, -1000), min(info.max, 1000),
                       shape).astype(dtype)


def _batches():
    """Named batches: per-request feed lists, ragged across requests."""
    out = {f"one_{d}": [[_arr(d, (2, 3), i)]] for i, d in enumerate(DTYPES)}
    out["ragged"] = [[_arr("float32", (1, 5), 1), _arr("int64", (1, 5), 2)],
                     [_arr("float32", (3, 2), 3)],
                     [],
                     [_arr("bool", (4,), 4), _arr("int8", (2, 2, 2), 5),
                      _arr("float16", (1, 1), 6)]]
    out["empty_arrays"] = [[np.zeros((0, 4), np.int32),
                            np.zeros((2, 0), np.float16)]]
    out["empty_batch"] = []
    out["noncontiguous"] = [[np.arange(24, dtype=np.float32)
                             .reshape(4, 6)[:, ::2]]]
    return out


BATCHES = _batches()


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _same_feeds(x, y):
    assert len(x) == len(y)
    for fx, fy in zip(x, y):
        assert len(fx) == len(fy)
        for a, b in zip(fx, fy):
            _same(np.asarray(a), np.asarray(b))


def test_zero_d_array_travels_as_one_element_in_both():
    """``np.ascontiguousarray`` gives a 0-d array one axis, so both
    packages write (and read back) shape (1,)."""
    feeds = [[np.float32(2.5).reshape(())]]
    pb, jb = pcodec.encode_batch(feeds), jcodec.encode_batch(feeds)
    assert pb == jb
    for dec in (pcodec.decode_batch(jb), jcodec.decode_batch(pb)):
        _same(dec[0][0], np.array([2.5], np.float32))


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_batch_bytes_equal_and_cross_decode(name):
    feeds = BATCHES[name]
    pb, jb = pcodec.encode_batch(feeds), jcodec.encode_batch(feeds)
    assert pb == jb
    assert pcodec.peek_batch_size(jb) == jcodec.peek_batch_size(pb) \
        == len(feeds)
    _same_feeds(pcodec.decode_batch(jb), feeds)
    _same_feeds(jcodec.decode_batch(pb), feeds)


def _errors(req, res):
    """The same typed errors, built from one package's classes."""
    quota = req.QuotaExceededError("tenant 'bulk' exceeded its quota",
                                   tenant="bulk")
    return [req.QueueFullError("full"), quota,
            req.DeadlineExceededError("late"),
            req.ServerClosedError("closed"),
            res.ReplicaWedgedError("wedged"), RuntimeError("boom"),
            ValueError("generic")]


def test_results_bytes_equal_and_types_cross():
    outs = [[_arr("float32", (2, 4), 7)], [],
            [_arr("int64", (3,), 8), _arr("bool", (1, 2), 9)]]
    pb = pcodec.encode_results(outs + _errors(preq, pres))
    jb = jcodec.encode_results(outs + _errors(jreq, jres))
    assert pb == jb
    for dec, req, res in ((pcodec.decode_results(jb), preq, pres),
                          (jcodec.decode_results(pb), jreq, jres)):
        _same_feeds(dec[:3], outs)
        errs = dec[3:]
        kinds = [req.QueueFullError, req.QuotaExceededError,
                 req.DeadlineExceededError, req.ServerClosedError,
                 res.ReplicaWedgedError, RuntimeError, RuntimeError]
        assert [type(e) for e in errs] == kinds
        assert errs[1].tenant == "bulk"
        assert str(errs[0]) == "QueueFullError: full"
        assert str(errs[6]) == "ValueError: generic"


TRAILERS = {
    "trace": ("attach_trace_trailer", ["00-" + "a" * 32 + "-" + "b" * 16
                                       + "-01", None, ""]),
    "deadline": ("attach_deadline_trailer", [12.5, None, -3.0]),
    "tenant": ("attach_tenant_trailer", ["bulk", None, "rt"]),
}
ORDERS = [("trace",), ("deadline",), ("tenant",), ("trace", "deadline"),
          ("deadline", "trace", "tenant"), ("tenant", "trace")]


@pytest.mark.parametrize("order", ORDERS, ids="-".join)
def test_trailers_bytes_equal_and_decode_alike(order):
    feeds = BATCHES["ragged"][:3]
    pb, jb = pcodec.encode_batch(feeds), jcodec.encode_batch(feeds)
    for part in order:
        fn, vals = TRAILERS[part]
        pb = getattr(pcodec, fn)(pb, vals)
        jb = getattr(jcodec, fn)(jb, vals)
        # a second stamp of the same section leaves the payload unchanged
        assert getattr(pcodec, fn)(pb, vals[::-1]) == pb
    assert pb == jb
    pf, pt, pd, pn = pcodec.decode_batch_trailers_ex(jb)
    jf, jt, jd, jn = jcodec.decode_batch_trailers_ex(pb)
    _same_feeds(pf, feeds)
    _same_feeds(jf, feeds)
    assert (pt, pd, pn) == (jt, jd, jn)
    want = {"trace": [TRAILERS["trace"][1][0], None, None],
            "deadline": [12.5, None, -3.0],
            "tenant": ["bulk", None, "rt"]}
    for part, got in zip(("trace", "deadline", "tenant"), (pt, pd, pn)):
        assert got == (want[part] if part in order else None)
    assert pcodec.decode_batch_ex(jb)[1] == jcodec.decode_batch_ex(pb)[1]
    assert pcodec.decode_batch_trailers(jb)[2] == \
        jcodec.decode_batch_trailers(pb)[2]


def _malformed():
    good = pcodec.encode_batch(BATCHES["ragged"][:2])
    res = pcodec.encode_results([[np.ones(3, np.float32)]])
    bad_size = bytearray(pcodec.encode_batch([[np.ones(4, np.float32)]]))
    # the u64 nbytes field of the only array: claim 12 bytes, not 16
    at = 4 + 4 + 4 + 1 + len(b"<f4") + 1 + 4
    bad_size[at:at + 8] = (12).to_bytes(8, "little")
    return {
        "empty": b"",
        "wrong_magic": b"XXXX" + good[4:],
        "truncated": good[:-3],
        "results_as_batch": res,
        "size_mismatch": bytes(bad_size),
        "unknown_trailer": good + b"ZZZZ" + (2).to_bytes(4, "little"),
        "duplicate_trailer": pcodec.attach_tenant_trailer(good, ["a", "b"])
        + b"PDTN" + (2).to_bytes(4, "little") + b"\0\0\0\0",
        "trailer_count": good + b"PDDL" + (5).to_bytes(4, "little"),
        "trailing_garbage": good + b"\x01",
    }


MALFORMED = _malformed()


@pytest.mark.parametrize("name", sorted(MALFORMED))
def test_malformed_batches_raise_codec_error_alike(name):
    data = MALFORMED[name]
    with pytest.raises(pcodec.CodecError) as pe:
        pcodec.decode_batch_trailers_ex(data)
    with pytest.raises(jcodec.CodecError) as je:
        jcodec.decode_batch_trailers_ex(data)
    assert str(pe.value) == str(je.value)


def test_malformed_results_and_stamps_raise_alike():
    one = pcodec.encode_results([[np.ones(3, np.float32)]])
    for data in (b"\xff", b"PDFB\0\0\0\0", one[:-2]):
        for codec in (pcodec, jcodec):
            with pytest.raises(codec.CodecError):
                codec.decode_results(data)
    good = pcodec.encode_batch([[np.ones(2, np.float32)]])
    for codec in (pcodec, jcodec):
        with pytest.raises(codec.CodecError, match="1 requests"):
            codec.attach_deadline_trailer(good, [1.0, 2.0])
        with pytest.raises(codec.CodecError):
            codec.peek_batch_size(b"PDFR")


def test_bfloat16_goes_out_under_its_name_and_comes_back():
    x = np.arange(12, dtype=np.float32).reshape(3, 4).astype(
        ml_dtypes.bfloat16)
    data = pcodec.encode_results([[x]])
    assert pcodec.BFLOAT16_TAG in data and b"<V2" not in data
    (back,), = pcodec.decode_results(data)
    assert back.dtype == np.dtype(ml_dtypes.bfloat16)
    assert back.tobytes() == x.tobytes() and back.shape == x.shape
    batch = pcodec.encode_batch([[x, np.ones(2, np.float32)]])
    _same_feeds(pcodec.decode_batch(batch), [[x, np.ones(2, np.float32)]])
    # the reference resolves the tag too (np.dtype('bfloat16') once
    # ml_dtypes is imported)
    (jback,), = jcodec.decode_results(data)
    assert jback.dtype == np.dtype(ml_dtypes.bfloat16)
    assert jback.tobytes() == x.tobytes()


def test_reference_bfloat16_reaches_the_peer_as_voids():
    """The reference's quirk, not the port's: it writes ``dtype.str``
    ('<V2') for bfloat16, so its peer decodes two-byte voids."""
    x = np.ones((2, 2), np.float32).astype(ml_dtypes.bfloat16)
    data = jcodec.encode_results([[x]])
    assert b"<V2" in data
    (jback,), = jcodec.decode_results(data)
    (pback,), = pcodec.decode_results(data)
    for got in (jback, pback):
        assert got.dtype.kind == "V" and got.dtype.itemsize == 2
        assert got.tobytes() == x.tobytes()
