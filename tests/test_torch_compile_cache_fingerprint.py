"""The port's compile-cache keys (``compile_cache/fingerprint.py``).

A hit must need the same code, layout, flags and environment: each of a
layer's width, its dtype, a compile-relevant flag, the environment
fingerprint and a function's source or closure constant turns a key into
another one, while weight values and a rebuilt model of the same layout do
not. Functions of plain Python key exactly as in ``paddle_tpu``;
``mesh_fingerprint(None)`` is the reference's token and a real mesh names
ROADMAP item 5c; the environment holds torch's, CUDA's and the kernel
library's identity and no JAX field.
"""
import pytest
import torch

from paddle_tpu.compile_cache import fingerprint as jfp
from paddle_tpu_torch.compile_cache import fingerprint as pfp
from paddle_tpu_torch.framework import flags as pflags
from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny

SCALE = 3


def _plain(x, y=2):
    return (x + SCALE) * y


def _gpt(seed=0, dtype=torch.float32, **cfg):
    return GPTForCausalLM(gpt_tiny(**cfg), device="cpu", dtype=dtype,
                          seed=seed)


def test_plain_functions_key_as_the_reference():
    assert pfp.function_fingerprint(_plain) == \
        jfp.function_fingerprint(_plain)
    assert pfp.bytes_fingerprint(b"abc") == jfp.bytes_fingerprint(b"abc")
    assert pfp.mesh_fingerprint(None) == jfp.mesh_fingerprint(None) == "none"
    # a real mesh keys by its axes, degrees and slots (item 5c, part 1)
    from paddle_tpu_torch.distributed.mesh_utils import build_mesh
    two = pfp.mesh_fingerprint(build_mesh({"mp": 2}, devices=["cpu"] * 2))
    assert two != "none" and '"mp": 2' in two
    assert two != pfp.mesh_fingerprint(build_mesh({"dp": 2},
                                                  devices=["cpu"] * 2))


def test_function_source_and_closure_change_the_key():
    def make(k):
        return lambda x: x * k
    f2, f3 = make(2), make(3)
    assert pfp.function_fingerprint(f2) == pfp.function_fingerprint(make(2))
    assert pfp.function_fingerprint(f2) != pfp.function_fingerprint(f3)
    assert pfp.function_fingerprint(lambda x: x + 1) != \
        pfp.function_fingerprint(lambda x: x + 2)


def test_layer_fingerprint_follows_layout_not_values():
    base = pfp.layer_fingerprint(_gpt(seed=0))
    assert pfp.layer_fingerprint(_gpt(seed=1)) == base      # values
    assert pfp.layer_fingerprint(_gpt(hidden_size=128)) != base  # width
    assert pfp.layer_fingerprint(_gpt(dtype=torch.bfloat16)) != base
    assert pfp.layer_fingerprint(_gpt(num_layers=3)) != base
    frozen = _gpt()
    next(frozen.parameters()).requires_grad_(False)
    assert pfp.layer_fingerprint(frozen) != base
    eps = _gpt()
    ln = next(m for m in eps.modules()
              if isinstance(m, torch.nn.LayerNorm))
    ln.eps = 1e-3
    assert pfp.layer_fingerprint(eps) != base
    hooked = _gpt()
    hooked.register_forward_hook(lambda m, i, o: o)
    assert pfp.layer_fingerprint(hooked) != base


def test_cache_key_covers_flags_and_environment(monkeypatch):
    sig = [torch.zeros(2, 8, dtype=torch.int64)]
    key, parts = pfp.cache_key("fp", sig, mesh=None, extra={"site": "s"})
    assert pfp.cache_key("fp", [torch.ones(2, 8, dtype=torch.int64)],
                         mesh=None, extra={"site": "s"})[0] == key
    assert parts["mesh"] == "none" and parts["extra"] == {"site": "s"}
    assert parts["args"][0] == [[["2", "8"], "int64", False, ""]]
    assert pfp.cache_key("fp", [torch.zeros(2, 9, dtype=torch.int64)],
                         mesh=None)[0] != key
    assert pfp.cache_key("fp", [torch.zeros(2, 8, dtype=torch.int32)],
                         mesh=None)[0] != key
    assert pfp.cache_key("fp2", sig, mesh=None, extra={"site": "s"})[0] \
        != key
    # a compile-relevant flag
    assert "FLAGS_serving_donate_inputs" in pfp.compile_relevant_flags()
    assert "FLAGS_tpu_matmul_precision" not in pfp.compile_relevant_flags()
    pflags.set_flags({"FLAGS_serving_donate_inputs": False})
    try:
        assert pfp.cache_key("fp", sig, mesh=None,
                             extra={"site": "s"})[0] != key
    finally:
        pflags.set_flags({"FLAGS_serving_donate_inputs": True})
    # a flag marked compile-relevant joins every key
    pflags.define_flag("FLAGS_test_cc_knob", 1, "test knob")
    pfp.mark_compile_relevant("test_cc_knob")
    try:
        k1 = pfp.cache_key("fp", sig, mesh=None)[0]
        pflags.set_flags({"FLAGS_test_cc_knob": 2})
        assert pfp.cache_key("fp", sig, mesh=None)[0] != k1
    finally:
        pfp._COMPILE_RELEVANT_FLAGS.discard("FLAGS_test_cc_knob")
        pflags._REGISTRY.pop("FLAGS_test_cc_knob", None)
    # the environment: every field is keyed
    env = pfp.environment_fingerprint()
    assert set(env) == {"torch", "cuda", "device_kind", "n_devices",
                        "kernel_library", "allow_tf32", "matmul_precision"}
    assert not any("jax" in k for k in env)
    for field, value in (("torch", "0.0"), ("kernel_library", "x"),
                         ("device_kind", "other card")):
        monkeypatch.setattr(pfp, "environment_fingerprint",
                            lambda f=field, v=value: dict(env, **{f: v}))
        assert pfp.cache_key("fp", sig, mesh=None,
                             extra={"site": "s"})[0] != key
    monkeypatch.undo()
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(
        "high" if prev == "highest" else "highest")
    try:
        assert pfp.cache_key("fp", sig, mesh=None,
                             extra={"site": "s"})[0] != key
    finally:
        torch.set_float32_matmul_precision(prev)


def test_avals_signature_leaves_match_the_reference():
    import numpy as np
    xs = [np.zeros((2, 8), np.int64), np.zeros((3,), np.float32)]
    want = jfp.avals_signature(xs)[0]
    assert pfp.avals_signature(xs)[0] == want
    assert pfp.avals_signature([torch.from_numpy(x) for x in xs])[0] == want
    # two tree layouts with the same leaves differ
    assert pfp.avals_signature({"a": xs[0]}) != \
        pfp.avals_signature([xs[0]])
