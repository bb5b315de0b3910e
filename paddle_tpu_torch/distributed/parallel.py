"""``paddle.DataParallel`` on one device: the port of
``paddle_tpu/distributed/parallel.py``.

The port's ``distributed`` is one device (meshes and collectives wait for
ROADMAP queue 1, item 5c): the rank is 0 of a world of 1, and
``DataParallel`` is the wrapped model itself, with the reference's
``scale_loss`` and ``apply_collective_grads`` (nothing to scale or reduce
over one device) and its state dict under the wrapped model's names.
"""
from __future__ import annotations

from ..nn.layer.layers import Layer

__all__ = ["DataParallel", "get_rank", "get_world_size"]


def get_rank(group=None) -> int:
    return 0


def get_world_size(group=None) -> int:
    return 1


class DataParallel(Layer):
    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        self._layers = layers
        self.find_unused_parameters = find_unused_parameters

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def scale_loss(self, loss):
        return loss

    def apply_collective_grads(self):
        pass

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.set_state_dict(state_dict, *args, **kwargs)

    set_dict = set_state_dict
    load_dict = set_state_dict
