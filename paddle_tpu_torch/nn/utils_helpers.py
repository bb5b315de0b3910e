"""``paddle.nn.utils``'s functions: the port of
``paddle_tpu/nn/utils_helpers.py``. ``weight_norm``, ``remove_weight_norm``
and ``spectral_norm`` return the layer unchanged, as the reference's
(ROADMAP queue 3 lists it)."""
from __future__ import annotations

import types

__all__ = ["parameters_to_vector", "vector_to_parameters", "weight_norm",
           "remove_weight_norm", "spectral_norm", "utils"]


def parameters_to_vector(parameters, name=None):
    """The parameters flattened and concatenated into one 1-D tensor."""
    from ..tensor.manipulation import concat, reshape
    return concat([reshape(p, [-1]) for p in parameters], axis=0)


def vector_to_parameters(vec, parameters, name=None):
    """Write consecutive slices of ``vec`` into ``parameters`` in place."""
    offset = 0
    for p in parameters:
        n = p.size
        p.set_value(vec[offset:offset + n].reshape(p.shape))
        offset += n


def weight_norm(layer, name="weight", dim=0):
    return layer


def remove_weight_norm(layer, name="weight"):
    return layer


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12,
                  dim=None):
    return layer


utils = types.SimpleNamespace(
    parameters_to_vector=parameters_to_vector,
    vector_to_parameters=vector_to_parameters, weight_norm=weight_norm,
    remove_weight_norm=remove_weight_norm, spectral_norm=spectral_norm)
