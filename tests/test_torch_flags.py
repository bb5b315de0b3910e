"""Decode flags set in both packages at once, for the port's parity tests.

``kv_dtype_flag`` sets ``FLAGS_decode_kv_dtype`` in ``paddle_tpu`` and in
``paddle_tpu_torch`` and restores both values after, also when the body
raises; ``pin_kv_dtype`` is an autouse fixture that runs every test of a
module with the flag at '' in both packages. Flags are process state, so a
value left set by one test reaches whatever test the same xdist worker runs
next; a module imports both names from here (``from test_torch_flags
import kv_dtype_flag, pin_kv_dtype``) so there is one copy to keep right.

The serving fleet's and the autoscaler's flags (``FLAGS_fleet_*``,
``FLAGS_autoscale_*``, the warmup gate and the canary period), and elastic
training's (``FLAGS_ckpt_*``, the goodput tolerance) carry the
reference's names and defaults.
"""
import contextlib

import pytest

from paddle_tpu.framework import flags as jflags
from paddle_tpu_torch.framework import flags as tflags

FLAG = "FLAGS_decode_kv_dtype"


@contextlib.contextmanager
def kv_dtype_flag(value):
    """FLAGS_decode_kv_dtype set to ``value`` in both packages, restored
    after."""
    old = (jflags.flag_value(FLAG), tflags.flag_value(FLAG))
    jflags.set_flags({FLAG: value})
    tflags.set_flags({FLAG: value})
    try:
        yield
    finally:
        jflags.set_flags({FLAG: old[0]})
        tflags.set_flags({FLAG: old[1]})


@pytest.fixture(autouse=True)
def pin_kv_dtype():
    """The test starts with FLAGS_decode_kv_dtype at '' in both packages,
    whatever an earlier test in this process left behind."""
    with kv_dtype_flag(""):
        yield


def _both():
    return jflags.flag_value(FLAG), tflags.flag_value(FLAG)


@pytest.mark.parametrize("value", ["int8", "bfloat16"])
def test_kv_dtype_flag_sets_both_and_restores(value):
    assert _both() == ("", "")
    with kv_dtype_flag(value):
        assert _both() == (value, value)
    assert _both() == ("", "")


def test_kv_dtype_flag_restores_after_an_error():
    with pytest.raises(RuntimeError, match="inside"):
        with kv_dtype_flag("int8"):
            raise RuntimeError("inside")
    assert _both() == ("", "")
    with kv_dtype_flag("int8"):
        with kv_dtype_flag("float32"):
            assert _both() == ("float32", "float32")
        assert _both() == ("int8", "int8")


FLEET_PREFIXES = ("FLAGS_fleet_", "FLAGS_autoscale_")
FLEET_FLAGS = sorted(
    n for n in jflags._REGISTRY if n.startswith(FLEET_PREFIXES)) + [
    "FLAGS_serving_ready_requires_warmup", "FLAGS_numerics_canary_period_s"]


def test_fleet_flags_cover_the_reference():
    assert len(FLEET_FLAGS) == 25
    ours = {n for n in tflags._REGISTRY if n.startswith(FLEET_PREFIXES)}
    assert ours == set(FLEET_FLAGS[:-2])


@pytest.mark.parametrize("name", FLEET_FLAGS)
def test_fleet_flag_defaults_equal_reference(name):
    assert tflags.flag_value(name) == jflags.flag_value(name)
    assert type(tflags.flag_value(name)) is type(jflags.flag_value(name))


ELASTIC_FLAGS = ["FLAGS_ckpt_keep", "FLAGS_ckpt_interval_steps",
                 "FLAGS_ckpt_interval_s", "FLAGS_ckpt_async",
                 "FLAGS_ckpt_staleness_s", "FLAGS_ckpt_preempt_deadline_s",
                 "FLAGS_goodput_tolerance"]


def test_elastic_flags_cover_the_reference():
    import paddle_tpu.elastic  # noqa: F401 - defines the FLAGS_ckpt_* there
    ref = sorted(n for n in jflags._REGISTRY if n.startswith("FLAGS_ckpt_"))
    assert ref == sorted(ELASTIC_FLAGS[:6])
    assert all(n in tflags._REGISTRY for n in ELASTIC_FLAGS)


@pytest.mark.parametrize("name", ELASTIC_FLAGS)
def test_elastic_flag_defaults_equal_reference(name):
    import paddle_tpu.elastic  # noqa: F401
    assert tflags.flag_value(name) == jflags.flag_value(name)
    assert type(tflags.flag_value(name)) is type(jflags.flag_value(name))


# the runtime and numerics plane (observability/{runtime,xstats,numerics})
PLANE_FLAGS = (
    "FLAGS_profiler_span_metrics", "FLAGS_xstats_enable",
    "FLAGS_xstats_max_entries", "FLAGS_device_peak_flops",
    "FLAGS_device_peak_bytes_per_s", "FLAGS_profile_dir",
    "FLAGS_profile_ring", "FLAGS_profile_max_ms",
    "FLAGS_profile_min_interval_s", "FLAGS_profile_on_anomaly",
    "FLAGS_profile_anomaly_ms", "FLAGS_numerics_sample_rate",
    "FLAGS_numerics_shadow_rate", "FLAGS_numerics_canary_period_s",
    "FLAGS_check_nan_inf")


@pytest.mark.parametrize("name", PLANE_FLAGS)
def test_plane_flags_match_the_reference(name):
    """The plane's flags carry the reference's names and defaults: the
    numerics rates are off, xstats is on."""
    assert tflags._REGISTRY[name].default == jflags._REGISTRY[name].default
    assert type(tflags._REGISTRY[name].default) is \
        type(jflags._REGISTRY[name].default)


def test_flags_generation_moves_with_every_set():
    gen = tflags.flags_generation()
    tflags.set_flags({"FLAGS_xstats_enable": True})
    assert tflags.flags_generation() == gen + 1
