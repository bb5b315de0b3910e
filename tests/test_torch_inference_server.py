"""The port's dynamic-batching ``serving.InferenceServer`` against
``paddle_tpu``'s, on the CPU: a mirror of ``tests/test_serving.py``'s classes
in which every request also goes through the reference's server (or
predictor) over the same weights, and the two packages' responses are
compared.

The model is ``tests/test_serving.py``'s MLP fixture (weights carried from
the JAX model by ``convert.py``), saved by each package with a ``[None, 8]``
or a ``[None, None, 8]`` spec, and ``ernie_tiny``'s classifier for a
sequence-bucketed run. Tolerances: float32 rtol 1e-5, atol 1e-6 (as
``tests/test_serving.py``); ERNIE's logits atol 1e-5 (``test_torch_inference``);
the port's server against its own predictor bit for bit, except across
batch rows, where a batched product may sum in another order (rtol 1e-5,
atol 1e-6).
"""
import json
import threading
import time

import numpy as np
import pytest

from paddle_tpu import serving as jserving
from paddle_tpu.framework import flags as jflags
from paddle_tpu_torch import serving
from paddle_tpu_torch.framework import flags as pflags
from paddle_tpu_torch.framework import monitor
from paddle_tpu_torch.observability import tracing
from test_torch_inference import (ERNIE_ATOL, MLP_ATOL, MLP_RTOL,
                                  ernie_pair, jax_predictor, mlp_pair,
                                  port_predictor)


def _close(a, b, rtol=MLP_RTOL, atol=MLP_ATOL, msg=""):
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=msg)


@pytest.fixture()
def preds(tmp_path):
    """(port, reference) predictors of the MLP with a dynamic batch."""
    jm, pm = mlp_pair()
    return (port_predictor(pm, str(tmp_path / "p"), [None, 8], "float32",
                           "x"),
            jax_predictor(jm, str(tmp_path / "j"), [None, 8], "float32",
                          "x"))


@pytest.fixture()
def seq_preds(tmp_path):
    """(port, reference) predictors with batch and sequence axes."""
    jm, pm = mlp_pair()
    return (port_predictor(pm, str(tmp_path / "p"), [None, None, 8],
                           "float32", "x"),
            jax_predictor(jm, str(tmp_path / "j"), [None, None, 8],
                          "float32", "x"))


def _serve(pkg, pred, reqs, **kw):
    """Serve ``reqs`` (one feed each) through ``pkg``'s server, queued
    before the worker starts; returns the outputs and the snapshot."""
    srv = pkg.InferenceServer(pred, start=False, **kw)
    futs = srv.submit_many([[r] for r in reqs])
    srv.start()
    outs = [f.result(timeout=60)[0] for f in futs]
    snap = srv.metrics.snapshot()
    srv.shutdown()
    return outs, snap


class TestBatchingCorrectness:
    def test_coalesced_matches_serial_and_reference(self, preds):
        pp, jp = preds
        rng = np.random.RandomState(0)
        reqs = [rng.randn(rng.randint(1, 4), 8).astype("float32")
                for _ in range(12)]
        kw = dict(max_batch_size=8, max_wait_ms=20)
        outs, snap = _serve(serving, pp, reqs, name="tp_coal", **kw)
        jouts, jsnap = _serve(jserving, jp, reqs, name="tj_coal", **kw)
        for r, o, jo in zip(reqs, outs, jouts):
            assert o.shape == (r.shape[0], 4)
            _close(o, pp.run([r])[0])
            _close(o, jo)
        assert 0 < snap["counters"]["batches"] < len(reqs)
        assert snap["counters"]["batches"] == jsnap["counters"]["batches"]
        assert snap["counters"]["completed"] == len(reqs)

    def test_run_many_matches_run_and_reference(self, preds):
        pp, jp = preds
        rng = np.random.RandomState(1)
        reqs = [rng.randn(n, 8).astype("float32") for n in (1, 3, 2)]
        outs = pp.run_many([[r] for r in reqs])
        jouts = jp.run_many([[r] for r in reqs])
        assert len(outs) == len(reqs)
        for r, o, jo in zip(reqs, outs, jouts):
            _close(o[0], pp.run([r])[0])
            _close(o[0], jo[0])

    def test_dispatch_then_fetch(self, preds):
        pp, jp = preds
        x = np.random.RandomState(15).randn(5, 8).astype("float32")
        pending = pp.dispatch_many([[x[:2]], [x[2:]]])
        got = pp.fetch_many(pending.block())
        want = jp.fetch_many(jp.dispatch_many([[x[:2]], [x[2:]]]))
        for o, jo in zip(got, want):
            _close(o[0], jo[0])

    def test_dict_feeds_and_submit_validation(self, preds):
        pp, jp = preds
        x = np.random.RandomState(2).randn(2, 8).astype("float32")
        srv = serving.InferenceServer(pp, max_batch_size=4, name="tp_val",
                                      start=False)
        fut = srv.submit({"x": x})
        with pytest.raises(KeyError):
            srv.submit({"wrong_name": x})
        with pytest.raises(ValueError):
            srv.submit([np.zeros((9, 8), "float32")])   # > max rows
        srv.shutdown()              # the inline drain resolves fut
        _close(fut.result(timeout=60)[0], jp.run([x])[0])


class TestShapeBucketing:
    def test_padded_matches_unpadded_and_reference(self, seq_preds):
        pp, jp = seq_preds
        rng = np.random.RandomState(3)
        reqs = [rng.randn(b, s, 8).astype("float32")
                for b, s in [(1, 3), (2, 5), (1, 7), (2, 2)]]
        kw = dict(max_batch_size=4, max_wait_ms=20, seq_buckets=[4, 8],
                  seq_axis=1)
        outs, snap = _serve(serving, pp, reqs, name="tp_seq", **kw)
        jouts, jsnap = _serve(jserving, jp, reqs, name="tj_seq", **kw)
        for r, o, jo in zip(reqs, outs, jouts):
            assert o.shape == jo.shape == (r.shape[0], r.shape[1], 4)
            _close(o, pp.run([r])[0])
            _close(o, jo)
        assert snap["padding"] == jsnap["padding"]
        assert snap["padding"]["waste_ratio"] > 0

    def test_policy_lattice_matches_reference(self):
        kw = dict(max_batch_size=8, seq_buckets=[4, 8], seq_axis=1)
        pol, jpol = (serving.ShapeBucketPolicy(**kw),
                     jserving.ShapeBucketPolicy(**kw))
        for n in (1, 2, 3, 5, 8):
            assert pol.bucket_batch(n) == jpol.bucket_batch(n)
        for s in (1, 4, 5, 8, 9, 17):
            assert pol.bucket_seq(s) == jpol.bucket_seq(s)
        a = np.ones((2, 3, 8), "float32")
        (padded,) = pol.pad_request_seq([a])
        np.testing.assert_array_equal(padded, jpol.pad_request_seq([a])[0])
        assert pol.signature([a]) == jpol.signature([a])
        assert pol.elements_per_row(pol.signature([a])) == \
            jpol.elements_per_row(jpol.signature([a]))
        np.testing.assert_array_equal(pol.pad_rows(a, 4),
                                      jpol.pad_rows(a, 4))
        out = np.ones((2, 4, 5))
        assert pol.unpad_output(out, 3).shape == \
            jpol.unpad_output(out, 3).shape == (2, 3, 5)

    def test_warmup_bounds_signatures(self, seq_preds):
        """As the reference: warmup runs the whole lattice once (every
        signature a miss) and traffic after it only hits."""
        pp, jp = seq_preds
        rng = np.random.RandomState(4)
        reqs = [rng.randn(b, s, 8).astype("float32")
                for b, s in [(1, 3), (2, 5), (1, 7), (2, 2), (4, 8)]]
        snaps = []
        for pkg, pred, name in ((serving, pp, "tp_warm"),
                                (jserving, jp, "tj_warm")):
            srv = pkg.InferenceServer(pred, max_batch_size=4,
                                      seq_buckets=[4, 8], seq_axis=1,
                                      name=name, start=False)
            specs = srv.bucket_specs()
            assert len(specs) == 3 * 2          # {1,2,4} x {4,8}
            assert srv.warmup() == len(specs)
            futs = srv.submit_many([[r] for r in reqs])
            srv.start()
            outs = [f.result(timeout=60)[0] for f in futs]
            snaps.append((outs, srv.metrics.snapshot()["compile_cache"]))
            srv.shutdown()
        (outs, cc), (jouts, jcc) = snaps
        assert cc["misses"] == jcc["misses"] == 6
        assert cc["signatures"] == jcc["signatures"]
        assert cc["hits"] >= 1
        for o, jo in zip(outs, jouts):
            _close(o, jo)

    def test_ernie_served_in_buckets_matches_reference(self, tmp_path):
        """ernie_tiny's classifier behind a sequence bucket, four rows a
        batch: each response equals the port's predictor on that request
        padded to its bucket, and the reference server's. (The reference's
        export takes neither of ERNIE's axes as dynamic: its position-table
        slice has no symbolic extent. Its predictor is saved at [1, 32] and
        its server runs one row a batch; the port's takes any shape.)"""
        jm, pm = ernie_pair()
        pp = port_predictor(pm, str(tmp_path / "p"), [None, None], "int64",
                            "ids")
        jp = jax_predictor(jm, str(tmp_path / "j"), [1, 32], "int64", "ids")
        rng = np.random.RandomState(5)
        reqs = [rng.randint(1, 256, (1, rng.randint(2, 33))).astype(np.int64)
                for _ in range(10)]
        outs, snap = _serve(serving, pp, reqs, name="tp_ernie",
                            max_batch_size=4, max_wait_ms=20,
                            seq_buckets=[32])
        jouts, _ = _serve(jserving, jp, reqs, name="tj_ernie",
                          max_batch_size=1, seq_buckets=[32])
        assert snap["counters"]["batches"] < len(reqs)
        pol = serving.ShapeBucketPolicy(seq_buckets=[32])
        for r, o, jo in zip(reqs, outs, jouts):
            _close(o, pp.run(pol.pad_request_seq([r]))[0])
            _close(o, jo, rtol=0, atol=ERNIE_ATOL)


class TestPipeline:
    @pytest.mark.parametrize("depth", [0, 2])
    def test_pipeline_depth_gives_the_same_results(self, preds, depth):
        pp, jp = preds
        rng = np.random.RandomState(6)
        reqs = [rng.randn(rng.randint(1, 3), 8).astype("float32")
                for _ in range(20)]
        outs, snap = _serve(serving, pp, reqs, max_batch_size=4,
                            max_wait_ms=5, pipeline_depth=depth,
                            name=f"tp_depth{depth}")
        jouts, _ = _serve(jserving, jp, reqs, max_batch_size=4,
                          max_wait_ms=5, pipeline_depth=depth,
                          name=f"tj_depth{depth}")
        for o, jo in zip(outs, jouts):
            _close(o, jo)
        assert snap["stage_ms"]["count"] == snap["counters"]["batches"]


class TestRobustness:
    def test_backpressure_queue_full(self, preds):
        pp, jp = preds
        for pkg, pred, name in ((serving, pp, "tp_bp"),
                                (jserving, jp, "tj_bp")):
            srv = pkg.InferenceServer(pred, queue_capacity=2, name=name,
                                      start=False)
            srv.submit([np.zeros((1, 8), "float32")])
            srv.submit([np.zeros((1, 8), "float32")])
            with pytest.raises(pkg.QueueFullError):
                srv.submit([np.zeros((1, 8), "float32")])
            snap = srv.metrics.snapshot()
            assert snap["counters"]["rejected"] == 1
            assert snap["queue"] == {"depth": 2, "capacity": 2,
                                     "peak_depth": 2}
            srv.shutdown()

    def test_deadline_expiry(self, preds):
        pp, _ = preds
        srv = serving.InferenceServer(pp, name="tp_dl", start=False)
        fut = srv.submit([np.zeros((1, 8), "float32")], timeout_ms=1)
        time.sleep(0.03)                # expire while queued
        srv.start()
        with pytest.raises(serving.DeadlineExceededError):
            fut.result(timeout=60)
        assert srv.metrics.snapshot()["counters"]["timed_out"] == 1
        srv.shutdown()
        assert issubclass(serving.DeadlineExceededError, TimeoutError)
        assert issubclass(serving.QuotaExceededError, serving.QueueFullError)

    def test_graceful_drain(self, preds):
        pp, jp = preds
        rng = np.random.RandomState(7)
        reqs = [rng.randn(1, 8).astype("float32") for _ in range(6)]
        srv = serving.InferenceServer(pp, max_wait_ms=50, name="tp_drain",
                                      start=False)
        futs = srv.submit_many([[r] for r in reqs])
        srv.start()
        srv.shutdown(drain=True)        # every queued request finishes
        for f, r in zip(futs, reqs):
            assert f.done()
            _close(f.result()[0], jp.run([r])[0])
        with pytest.raises(serving.ServerClosedError):
            srv.submit([reqs[0]])
        assert not srv.ready

    def test_nondrain_shutdown_fails_pending(self, preds):
        pp, _ = preds
        srv = serving.InferenceServer(pp, name="tp_abort", start=False)
        fut = srv.submit([np.zeros((1, 8), "float32")])
        srv.shutdown(drain=False)
        with pytest.raises(serving.ServerClosedError):
            fut.result(timeout=10)
        assert srv.metrics.snapshot()["counters"]["cancelled"] == 1

    def test_worker_survives_model_error(self, preds):
        """A bad request fails its batch only, in both packages."""
        pp, jp = preds
        for pkg, pred, name in ((serving, pp, "tp_err"),
                                (jserving, jp, "tj_err")):
            srv = pkg.InferenceServer(pred, max_wait_ms=1, name=name)
            bad = srv.submit([np.zeros((1, 5), "float32")])   # wrong dim
            with pytest.raises(Exception):
                bad.result(timeout=60)
            good = srv.submit([np.ones((1, 8), "float32")])
            good.result(timeout=60)     # server still alive
            assert srv.metrics.snapshot()["counters"]["failed"] == 1
            srv.shutdown()

    def test_ready_gate(self, preds):
        pp, _ = preds
        srv = serving.InferenceServer(pp, ready_requires_warmup=True,
                                      name="tp_ready", start=False)
        assert not srv.ready
        srv.warmup([1, 2])
        assert srv.ready
        srv.shutdown()
        srv = serving.InferenceServer(pp, ready_requires_warmup=True,
                                      name="tp_ready2", start=False)
        srv.mark_ready()
        assert srv.ready
        srv.shutdown()

    def test_left_out_options_raise(self, preds):
        pp, _ = preds
        # the scheduler and the telemetry endpoint are ported now (tests/
        # test_torch_obs_httpd.py, tests/test_torch_scheduling.py)
        from paddle_tpu_torch.observability import stop_telemetry_server
        from paddle_tpu_torch.serving.scheduling import AdmissionController
        srv = serving.InferenceServer(
            pp, name="tp_left_sched",
            scheduler=AdmissionController(name="tp_left_sched"),
            telemetry_port=0, start=False)
        assert srv.telemetry is not None and srv.telemetry.port > 0
        srv.shutdown()
        stop_telemetry_server()
        for flag, value, item in (("FLAGS_serving_capi_batching", True,
                                   "5d"),):
            pflags.set_flags({flag: value})
            try:
                with pytest.raises(NotImplementedError, match=item):
                    serving.InferenceServer(pp, start=False)
            finally:
                pflags.set_flags({flag: pflags._REGISTRY[flag].default})
        # a tensor-parallel replica is its predictor's business (item 5c,
        # part 1), as the reference's: the server reads no mesh flag
        pflags.set_flags({"FLAGS_serving_mesh_mp": 2})
        try:
            serving.InferenceServer(pp, name="tp_left_mesh",
                                    start=False).shutdown()
        finally:
            pflags.set_flags({"FLAGS_serving_mesh_mp": 1})
        # the warmup manifest is ported (tests/test_torch_warmup_manifest.
        # py): without a compile-cache directory there is none, a replay
        # runs nothing and the flag no longer refuses the server
        pflags.set_flags({"FLAGS_serving_warmup_from_manifest": True})
        try:
            srv = serving.InferenceServer(pp, name="tp_left", start=False,
                                          ready_requires_warmup=True)
        finally:
            pflags.set_flags({"FLAGS_serving_warmup_from_manifest": False})
        assert srv.warmup_manifest is None and not srv.ready
        # as the reference's: nothing to replay warms nothing
        assert srv.warmup_from_manifest() == 0 and not srv.ready
        srv.shutdown()


def _keys(d):
    """The nested key set of a snapshot (the histogram's row keys, which
    depend on the traffic, left out)."""
    return {k: (_keys(v) if isinstance(v, dict) and k != "batch_size_hist"
                else None) for k, v in d.items()}


class TestMetrics:
    def test_schema_equals_reference(self, preds, tmp_path):
        pp, jp = preds
        rng = np.random.RandomState(10)
        reqs = [rng.randn(2, 8).astype("float32") for _ in range(5)]
        snaps = []
        for pkg, pred, name in ((serving, pp, "tp_metrics"),
                                (jserving, jp, "tj_metrics")):
            srv = pkg.InferenceServer(pred, max_wait_ms=5, name=name,
                                      start=False)
            futs = srv.submit_many([[r] for r in reqs])
            srv.start()
            for f in futs:
                f.result(timeout=60)
            snaps.append(json.loads(srv.metrics_json()))
            if pkg is serving:
                path = str(tmp_path / "metrics.json")
                srv.metrics.export_json(path)
                assert json.loads(open(path).read())["server"] == name
            srv.shutdown()
        snap, jsnap = snaps
        assert _keys(snap) == _keys(jsnap)
        assert snap["counters"] == dict(jsnap["counters"])
        assert snap["latency_ms"]["count"] == 5
        assert snap["latency_ms"]["p50"] <= snap["latency_ms"]["p99"]
        assert sum(snap["batch_size_hist"].values()) == \
            snap["counters"]["batches"]
        assert serving.metrics.get("tp_metrics") is None   # unregistered

    def test_registry_families_agree_with_the_snapshot(self, preds):
        """The server's recordings land in the process-wide registry's
        families under the reference's names, in step with its
        snapshot."""
        from paddle_tpu_torch.observability.registry import default_registry
        pp, _ = preds
        srv = serving.InferenceServer(pp, max_wait_ms=5, name="tp_reg",
                                      start=False)
        futs = srv.submit_many([[np.ones((2, 8), "float32")]] * 3)
        srv.start()
        for f in futs:
            f.result(timeout=60)
        snap = srv.metrics.snapshot()
        srv.shutdown()
        reg = default_registry()
        events = reg.get("paddle_serving_requests_total")
        assert events.get(server="tp_reg", event="completed").value == 3
        lat = reg.get("paddle_serving_latency_ms").get(server="tp_reg")
        assert lat.count == 3 and lat.buckets()[-1] == (float("inf"), 3)
        assert 0 < lat.sum <= 3 * snap["latency_ms"]["max"] + 1e-9
        rows = reg.get("paddle_serving_batch_rows").get(server="tp_reg")
        assert rows.count == snap["counters"]["batches"]
        assert reg.get("paddle_serving_queue_capacity").get(
            server="tp_reg").value == 64

    def test_monitor_registry_wiring(self, preds):
        pp, _ = preds
        monitor.stat_reset()
        srv = serving.InferenceServer(pp, max_wait_ms=1, name="tp_mon")
        assert serving.metrics.all_snapshots()["tp_mon"]["server"] == \
            "tp_mon"
        srv.submit([np.zeros((1, 8), "float32")]).result(timeout=60)
        srv.shutdown()
        assert monitor.stat_get("serving_tp_mon_submitted") == 1
        assert monitor.stat_get("serving_tp_mon_completed") == 1
        assert monitor.stat_get("serving_tp_mon_batches") == 1

    def test_serving_flag_defaults_equal_reference(self):
        names = [n for n in jflags._REGISTRY
                 if n.startswith("FLAGS_serving_")]
        assert len(names) >= 13
        for n in names:
            assert pflags.flag_value(n) == jflags.flag_value(n), n

    def test_traced_request_records_its_stages(self, preds):
        pp, _ = preds
        ctx = tracing.new_context(sampled=True)
        srv = serving.InferenceServer(pp, max_wait_ms=1, name="tp_trace")
        with tracing.use_context(ctx):
            fut = srv.submit([np.zeros((1, 8), "float32")])
        untraced = srv.submit([np.zeros((1, 8), "float32")])
        fut.result(timeout=60)
        untraced.result(timeout=60)
        srv.shutdown()
        mine = tracing.spans(ctx.trace_id)
        assert {s["stage"] for s in mine} == {
            "queue", "assembly", "dispatch", "device_wait", "fetch",
            "request"}
        # the request's span is a child of the caller's; its stages are
        # children of the request's
        root = [s for s in mine if s["stage"] == "request"]
        assert len(root) == 1 and root[0]["parent_id"] == ctx.span_id
        assert all(s["parent_id"] == root[0]["span_id"] for s in mine
                   if s is not root[0])


class TestStableOutputHandles:
    def test_handle_hoisted_across_runs(self, preds):
        """A handle fetched before the first run reads the current run's
        output every run."""
        pp, jp = preds
        h = pp.get_output_handle("fetch_0")
        rng = np.random.RandomState(12)
        x1 = rng.randn(2, 8).astype("float32")
        x2 = rng.randn(2, 8).astype("float32")
        pp.get_input_handle("x").copy_from_cpu(x1)
        pp.run()
        v1 = h.copy_to_cpu()
        pp.get_input_handle("x").copy_from_cpu(x2)
        pp.run()
        v2 = h.copy_to_cpu()
        assert pp.get_output_handle("fetch_0") is h
        assert not np.allclose(v1, v2)
        _close(v1, jp.run([x1])[0])
        _close(v2, jp.run([x2])[0])


class TestServeForever:
    def test_serve_forever_and_remote_shutdown(self, preds):
        pp, jp = preds
        x = np.random.RandomState(14).randn(1, 8).astype("float32")
        srv = serving.InferenceServer(pp, max_wait_ms=1, name="tp_sf",
                                      start=False)
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        fut = srv.submit([x])
        _close(fut.result(timeout=60)[0], jp.run([x])[0])
        srv.shutdown(drain=True)
        t.join(timeout=30)
        assert not t.is_alive()
