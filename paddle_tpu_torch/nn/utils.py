"""``paddle.nn.utils`` as an importable module (the port of
``paddle_tpu/nn/utils.py``)."""
from .utils_helpers import (parameters_to_vector, remove_weight_norm,  # noqa
                            spectral_norm, vector_to_parameters, weight_norm)

__all__ = ["parameters_to_vector", "remove_weight_norm", "spectral_norm",
           "vector_to_parameters", "weight_norm"]
