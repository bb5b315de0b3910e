"""The port's compile-cache disk store against ``paddle_tpu``'s.

``paddle_tpu_torch.compile_cache.CacheStore`` keeps the reference's
guarantees and on-disk layout (``<key>.pdcc`` pickled records, atomic
replace, corruption evicts, LRU by mtime within ``max_bytes`` that never
evicts the entry just written, a 0o700 directory). The same sequence of
puts, gets, corrupt files and evictions runs through both packages'
stores, each in a directory of its own, with the same mtimes; they evict
the same keys and report the same hits. Each test has its own temporary
directories.
"""
import os
import pickle
import stat

import pytest

from paddle_tpu.compile_cache import store as jstore
from paddle_tpu_torch.compile_cache import CompileCache
from paddle_tpu_torch.compile_cache import store as pstore


def _stores(tmp_path, max_bytes):
    return [(mod, mod.CacheStore(str(tmp_path / name), max_bytes))
            for mod, name in ((jstore, "ref"), (pstore, "port"))]


def _trace(store, t0, ops):
    """Run ``ops`` on ``store``; each put's file gets mtime t0 + its index
    (a get touches to the next tick), so both stores see one LRU order.
    Returns what each op observed and the keys left."""
    seen, tick = [], t0
    for op, key, *arg in ops:
        tick += 1
        if op == "put":
            store.put(key, {"kind": "record", "payload": arg[0],
                            "meta": None})
            os.utime(store.path_for(key), (tick, tick))
            seen.append(("put", sorted(k for k, _, _ in store.entries())))
        elif op == "get":
            try:
                rec = store.get(key)
                if rec is not None:
                    os.utime(store.path_for(key), (tick, tick))
                seen.append(("get", None if rec is None else rec["payload"]))
            except Exception as e:  # noqa: BLE001 - a corrupt entry
                seen.append(("corrupt", type(e).__name__,
                             os.path.exists(store.path_for(key))))
        elif op == "corrupt":
            with open(store.path_for(key), "wb") as f:
                f.write(arg[0])
            os.utime(store.path_for(key), (tick, tick))
        elif op == "evict":
            seen.append(("evict", store.evict_to_fit(keep=key)))
    return seen, sorted(k for k, _, _ in store.entries())


def test_same_sequence_same_evictions_and_hits(tmp_path):
    blob = {"flops": 1.0, "pad": "x" * 400}
    one = len(pickle.dumps({"kind": "record", "payload": blob, "meta": None,
                            "version": 1}, protocol=4))
    ops = [("put", "a", blob), ("put", "b", blob), ("get", "a"),
           ("put", "c", blob),                   # evicts b, the LRU
           ("get", "b"), ("get", "a"), ("get", "c"),
           ("corrupt", "a", b"not a pickle"), ("get", "a"),
           ("corrupt", "c", pickle.dumps({"version": 99})), ("get", "c"),
           ("put", "d", dict(blob, pad="y" * 4000)),   # oversized: kept
           ("get", "d"), ("put", "e", blob), ("evict", None)]
    results = [_trace(store, 1_000_000, ops)
               for _, store in _stores(tmp_path, 2 * one + 16)]
    assert results[0] == results[1]
    seen, left = results[1]
    assert ("get", None) in seen                    # b was evicted
    assert seen.count(("corrupt", "UnpicklingError", False)) == 1
    assert seen.count(("corrupt", "ValueError", False)) == 1
    assert left == ["e"]


def test_each_package_reads_the_others_records(tmp_path):
    (jm, js), (pm, ps) = _stores(tmp_path, 0)
    assert jm.RECORD_VERSION == pm.RECORD_VERSION == 1
    rec = {"kind": "record", "payload": {"flops": 12.0}, "meta": {"v": 1}}
    js.put("k", rec)
    ps.put("k", rec)
    for a, b in ((js, ps), (ps, js)):
        with open(a.path_for("k"), "rb") as f:
            raw = f.read()
        with open(b.path_for("other"), "wb") as f:
            f.write(raw)
        got = b.get("other")
        assert got == dict(rec, version=1)
        assert set(got) == {"version", "kind", "payload", "meta"}


def test_writes_are_atomic_and_the_directory_private(tmp_path):
    for _, store in _stores(tmp_path, 0):
        assert stat.S_IMODE(os.stat(store.directory).st_mode) == 0o700
        n = store.put("k", {"kind": "record", "payload": {}, "meta": None})
        assert n == os.path.getsize(store.path_for("k"))
        assert os.listdir(store.directory) == ["k.pdcc"]   # no temp left
        assert store.remove("k") and not store.remove("k")
        assert store.get("k") is None and store.total_bytes() == 0


def test_cache_counts_corruption_and_foreign_payloads(tmp_path):
    from paddle_tpu_torch.compile_cache import stats
    cache = CompileCache(str(tmp_path / "c"))
    before = stats()
    assert cache.store("k", {"flops": 3.0}, site="t") == "record"
    assert cache.load("k", site="t") == {"flops": 3.0}
    with open(cache.store_backend.path_for("k"), "wb") as f:
        f.write(b"\x00garbage")
    assert cache.load("k", site="t") is None
    # the reference's executable payload under a valid key: evicted
    cache.store_backend.put("x", {"kind": "executable", "payload": b"\x01",
                                  "meta": None})
    assert cache.load("x", site="t") is None
    assert not os.path.exists(cache.store_backend.path_for("x"))
    after = stats()
    delta = {k: after[k] - before[k] for k in ("hits", "misses", "errors",
                                               "stored", "fallbacks")}
    assert delta == {"hits": 1, "misses": 2, "errors": 2, "stored": 1,
                     "fallbacks": 0}
    # both entries were evicted as bad (the gauges, as the reference's,
    # follow the directory at the next store)
    assert cache.store_backend.entries() == []


@pytest.mark.parametrize("max_bytes", [0, 1])
def test_the_entry_just_written_is_never_evicted(tmp_path, max_bytes):
    results = []
    for _, store in _stores(tmp_path, max_bytes):
        for i, key in enumerate("abc"):
            store.put(key, {"kind": "record", "payload": {"i": i},
                            "meta": None})
            os.utime(store.path_for(key), (100 + i, 100 + i))
        results.append(sorted(k for k, _, _ in store.entries()))
    assert results[0] == results[1] == (["c"] if max_bytes else
                                        ["a", "b", "c"])
