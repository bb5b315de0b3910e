"""How much of the JAX package's Paddle surface the port offers.

For ``paddle_tpu``, ``paddle_tpu.tensor``, ``paddle_tpu.nn`` and
``paddle_tpu.nn.functional`` (``tests/fixtures/api_golden.json``'s
``surfaces``) it prints how many names the port's counterpart has; a name
that raises ``NotImplementedError`` and the reference's helper names do not
count. It fails when a name of its own list of covered names goes missing.
"""
import json
from pathlib import Path

import pytest

GOLDEN = Path(__file__).resolve().parent / "fixtures" / "api_golden.json"
# the reference's module-level helpers that its surfaces list: JAX
# internals, imports, aliases of its submodules and the submodule names
HELPERS = {"jax", "jnp", "np", "annotations", "apply_op", "unwrap",
           "flag_value", "current_jax_device", "slice_builtin", "dtype_mod",
           "einsum_mod", "random_mod", "creation", "linalg", "logic",
           "manipulation", "math", "random", "search", "stat"}
# the top-level names this slice ports beside the tensor surface
TOP = {"Tensor", "Parameter", "to_tensor", "grad", "no_grad", "enable_grad",
       "set_grad_enabled", "is_grad_enabled", "dtype", "bool", "bool8",
       "uint8", "int8", "int16", "int32", "int64", "float16", "bfloat16",
       "float32", "float64", "complex64", "complex128", "get_default_dtype",
       "set_default_dtype", "Place", "CPUPlace", "CUDAPlace",
       "CUDAPinnedPlace", "TPUPlace", "XPUPlace", "NPUPlace", "set_device",
       "get_device", "device_count", "is_compiled_with_cuda",
       "is_compiled_with_rocm", "is_compiled_with_tpu",
       "is_compiled_with_xpu", "synchronize", "seed", "get_rng_state",
       "set_rng_state", "get_flags", "set_flags", "ParamAttr", "save",
       "load", "in_dynamic_mode", "amp", "io", "jit", "inference", "nn",
       "optimizer", "profiler", "static", "vision", "distributed", "tensor",
       "framework", "core"}
NN = {"Layer", "Sequential", "LayerList", "LayerDict", "ParameterList",
      "Linear", "Embedding", "Dropout", "Identity", "Flatten", "LayerNorm",
      "CrossEntropyLoss", "ParamAttr", "ClipGradByGlobalNorm",
      "ClipGradByNorm", "ClipGradByValue", "functional", "initializer",
      "Conv2D", "BatchNorm2D", "MaxPool2D", "AdaptiveAvgPool2D", "ReLU",
      "ReLU6", "Sigmoid", "Tanh", "Silu", "Swish", "Mish", "Hardswish",
      "Hardsigmoid", "Softsign", "Tanhshrink", "LogSigmoid", "GELU",
      "LeakyReLU", "ELU", "CELU", "SELU", "Hardtanh", "Hardshrink",
      "Softshrink", "Softplus", "ThresholdedReLU", "Maxout", "Softmax",
      "LogSoftmax", "GLU", "RReLU", "PReLU", "Softmax2D"}
NN_F = {"linear", "embedding", "layer_norm", "softmax", "log_softmax",
        "flash_attention", "scaled_dot_product_attention", "dropout",
        "cross_entropy", "relu", "relu6", "sigmoid", "tanh", "silu",
        "softsign", "tanhshrink", "mish", "hardswish", "relu_", "gelu",
        "leaky_relu", "elu", "elu_", "selu", "celu", "swish", "hardtanh",
        "hardsigmoid", "hardshrink", "softshrink", "softplus",
        "thresholded_relu", "prelu", "rrelu", "maxout", "softmax_",
        "log_sigmoid", "glu", "gumbel_softmax", "conv2d", "batch_norm",
        "max_pool2d", "adaptive_avg_pool2d"}
PORTS = {"paddle_tpu": "paddle_tpu_torch",
         "paddle_tpu.tensor": "paddle_tpu_torch.tensor",
         "paddle_tpu.nn": "paddle_tpu_torch.nn",
         "paddle_tpu.nn.functional": "paddle_tpu_torch.nn.functional"}


def _offered(module, name) -> bool:
    """Present, and not a stub: the port leaves a name it does not port
    absent, or makes it raise ``NotImplementedError`` when used (a
    class's constructor, a function's call), which would not count; such
    stubs carry ``__not_ported__``."""
    obj = getattr(module, name, None)
    if obj is None and not hasattr(module, name):
        return False
    return not getattr(obj, "__not_ported__", False)


def _surface(ref_name):
    import importlib
    names = json.loads(GOLDEN.read_text())["surfaces"][ref_name]
    names = [n for n in names if n not in HELPERS]
    port = importlib.import_module(PORTS[ref_name])
    have = [n for n in names if _offered(port, n)]
    return names, have, port


@pytest.mark.parametrize("ref_name", sorted(PORTS))
def test_surface_coverage(ref_name):
    names, have, port = _surface(ref_name)
    print(f"{ref_name}: the port has {len(have)} of {len(names)} names "
          f"(helpers excluded); missing: "
          f"{sorted(set(names) - set(have))}")
    if ref_name == "paddle_tpu.tensor":
        # every op of paddle.tensor, also at the top level, as there
        assert len(have) >= 300
        import paddle_tpu_torch
        assert all(_offered(paddle_tpu_torch, n) for n in have)
        covered = set(have)
    else:
        covered = {"paddle_tpu": TOP, "paddle_tpu.nn": NN,
                   "paddle_tpu.nn.functional": NN_F}[ref_name]
    lost = sorted(n for n in covered if not _offered(port, n))
    assert not lost, f"{ref_name}: covered names went missing: {lost}"
