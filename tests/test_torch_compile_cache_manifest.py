"""The port's ``WarmupManifest`` against ``paddle_tpu``'s: the same JSON, so
each package reads the file the other wrote into the same specs, for every
site; a version-skewed, corrupt or missing file loads empty; pre-site
entries load as "predict"; the default path is the same. One temporary
directory per test.
"""
import json

import pytest

from paddle_tpu.compile_cache import manifest as jman
from paddle_tpu_torch.compile_cache import manifest as pman

SITES = ("predict", "generate_prefill", "generate_chunked",
         "generate_decode", "generate_verify")
FEEDS = {
    "predict": [((4, 64), "int64")],
    "generate_prefill": [((2, 32), "int64"), ((2,), "int32"),
                         ((2, 8), "int32")],
    "generate_chunked": [((1, 16), "int64"), ((1,), "int32"),
                         ((1,), "int32"), ((1, 8), "int32")],
    "generate_decode": [((4,), "int64"), ((4,), "int32"), ((4,), "bool"),
                        ((4,), "int32"), ((4, 8), "int32")],
    "generate_verify": [((4, 5), "int64"), ((4,), "int32"), ((4,), "int32"),
                        ((4, 8), "int32")],
}


def _fill(mod, path):
    m = mod.WarmupManifest(str(path))
    news = [m.record(FEEDS[s], site=s) for s in SITES]
    news.append(m.record(FEEDS["predict"], site="predict"))    # repeat
    return m, news


def _canon(specs):
    return sorted(json.dumps([s["site"], [[list(sh), d]
                                          for sh, d in s["feeds"]]])
                  for s in specs)


@pytest.mark.parametrize("writer,reader", [(jman, pman), (pman, jman)],
                         ids=["ref_writes", "port_writes"])
def test_each_package_reads_the_others_file(tmp_path, writer, reader):
    w, news = _fill(writer, tmp_path / "w.json")
    assert news == [True] * len(SITES) + [False]
    r = reader.WarmupManifest(str(tmp_path / "w.json"))
    assert len(r) == len(w) == len(SITES)
    assert _canon(r.specs()) == _canon(w.specs())
    for site in SITES:
        assert _canon(r.specs(site=site)) == _canon(w.specs(site=site))
        assert r.specs(site=site)[0]["feeds"] == [
            (tuple(sh), d) for sh, d in FEEDS[site]]
    # a second writer's file is byte for byte the first's
    _fill(reader, tmp_path / "r.json")
    assert (tmp_path / "r.json").read_bytes() == \
        (tmp_path / "w.json").read_bytes()


def test_skewed_corrupt_and_old_files(tmp_path):
    assert pman.MANIFEST_VERSION == jman.MANIFEST_VERSION == 1
    skew = tmp_path / "skew.json"
    skew.write_text(json.dumps({"version": 2, "entries": [
        {"feeds": [[[1, 8], "int64"]], "site": "predict"}]}))
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    old = tmp_path / "old.json"
    old.write_text(json.dumps({"version": 1, "entries": [
        {"feeds": [[[2, 8], "float32"]]}]}))
    for mod in (jman, pman):
        assert len(mod.WarmupManifest(str(skew))) == 0
        assert len(mod.WarmupManifest(str(bad))) == 0
        assert len(mod.WarmupManifest(str(tmp_path / "none.json"))) == 0
        assert mod.WarmupManifest(str(old)).specs() == [
            {"feeds": [((2, 8), "float32")], "site": "predict"}]


def test_default_path_and_unwritable_directory(tmp_path):
    args = (str(tmp_path), "replica-7/model_v1@ab cd", "0123456789abcdef99")
    assert pman.WarmupManifest.default_path(*args) == \
        jman.WarmupManifest.default_path(*args)
    blocked = tmp_path / "file"
    blocked.write_text("")
    m = pman.WarmupManifest(str(blocked / "sub" / "m.json"))
    assert m.record(FEEDS["predict"]) is True      # never raises
    assert len(m) == 1
