"""Recurrent layers: the port of ``paddle_tpu/nn/layer/rnn.py``.

``SimpleRNN``, ``LSTM`` and ``GRU`` (layers, directions, ``time_major``)
hold the reference's parameters, ``weight_ih_l{k}[_reverse]``,
``weight_hh_l{k}[_reverse]``, ``bias_ih_l{k}[_reverse]`` and
``bias_hh_l{k}[_reverse]`` (``:59-76``), each ``[gates · hidden, in]`` or
``[gates · hidden]``, drawn ``U(±1 / sqrt(hidden))``. The step formulas and
gate orders are the reference's (``:82-110``): LSTM's ``i, f, g, o``; GRU's
``r, u, c`` with ``c = tanh(ci + r · ch)`` and ``h = (1 - u) · c + u ·
h_prev``. The whole sequence is one op (the reference's
``apply_op(self.MODE.lower(), ...)``: "rnn_tanh", "lstm", "gru"), its time
loop plain torch ops over each step. Between stacked layers, in training,
``dropout`` drops the outputs as Paddle does (the reference ignores it).
``sequence_length`` is accepted and ignored, as the reference's
(``:112, 366, 391``).

The cells (``SimpleRNNCell``, ``LSTMCell``, ``GRUCell``) compute one step
with ``get_initial_states``; ``RNN`` runs a cell over time, ``BiRNN`` two.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...core.dispatch import apply_op
from .. import initializer as I
from ..functional.common import dropout
from ..initializer_utils import create_parameter_with_attr
from .layers import Layer

__all__ = ["SimpleRNN", "LSTM", "GRU", "RNNCellBase", "SimpleRNNCell",
           "LSTMCell", "GRUCell", "RNN", "BiRNN"]


def _rnn_step(x, state, w_ih, w_hh, b_ih, b_hh, activation="tanh"):
    (h_prev,) = state
    z = x @ w_ih.t() + b_ih + h_prev @ w_hh.t() + b_hh
    h = torch.tanh(z) if activation == "tanh" else torch.relu(z)
    return h, (h,)


def _lstm_step(x, state, w_ih, w_hh, b_ih, b_hh, activation=None):
    h_prev, c_prev = state
    z = x @ w_ih.t() + b_ih + h_prev @ w_hh.t() + b_hh
    i, f, g, o = torch.chunk(z, 4, -1)
    c = torch.sigmoid(f) * c_prev + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, (h, c)


def _gru_step(x, state, w_ih, w_hh, b_ih, b_hh, activation=None):
    (h_prev,) = state
    ri, ui, ci = torch.chunk(x @ w_ih.t() + b_ih, 3, -1)
    rh, uh, ch = torch.chunk(h_prev @ w_hh.t() + b_hh, 3, -1)
    r = torch.sigmoid(ri + rh)
    u = torch.sigmoid(ui + uh)
    c = torch.tanh(ci + r * ch)
    h = (1 - u) * c + u * h_prev
    return h, (h,)


_STEPS = {"RNN_TANH": _rnn_step, "LSTM": _lstm_step, "GRU": _gru_step}


def _uniform(hidden):
    std = 1.0 / math.sqrt(hidden)
    return I.Uniform(-std, std)


class _RNNBase(Layer):
    MODE = "RNN_TANH"
    GATES = 1

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.direction = direction
        self.time_major = time_major
        self.dropout = dropout
        self.activation = activation
        self.num_directions = 2 if direction in ("bidirect",
                                                 "bidirectional") else 1
        g = self.GATES * hidden_size
        init = _uniform(hidden_size)
        self.weights = []
        for layer in range(num_layers):
            for d in range(self.num_directions):
                in_sz = input_size if layer == 0 else \
                    hidden_size * self.num_directions
                sfx = f"_l{layer}" + ("_reverse" if d else "")
                names = (f"weight_ih{sfx}", f"weight_hh{sfx}",
                         f"bias_ih{sfx}", f"bias_hh{sfx}")
                for pname, shape, attr, is_bias in (
                        (names[0], [g, in_sz], weight_ih_attr, False),
                        (names[1], [g, hidden_size], weight_hh_attr, False),
                        (names[2], [g], bias_ih_attr, True),
                        (names[3], [g], bias_hh_attr, True)):
                    self.add_parameter(pname, create_parameter_with_attr(
                        shape, self._dtype, attr, is_bias,
                        default_initializer=init))
                self.weights.append(names)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        """``(outputs, final states)``: outputs ``[B, T, D · H]`` (``[T, B,
        D · H]`` when ``time_major``), final states ``[L · D, B, H]`` (a
        pair ``(h, c)`` for the LSTM)."""
        lstm = self.MODE == "LSTM"
        step = _STEPS[self.MODE]
        n_dir, n_layers, hid = self.num_directions, self.num_layers, \
            self.hidden_size
        t_axis = 0 if self.time_major else 1
        act, p_drop = self.activation, self.dropout
        training = self.training
        params = [self._parameters[n] for quad in self.weights for n in quad]
        extra = [] if initial_states is None else (
            list(initial_states) if lstm else [initial_states])

        def fn(x, *arrs):
            ps, rest = arrs[:len(params)], arrs[len(params):]
            batch = x.shape[1 - t_axis]
            if rest:
                h0, c0 = (rest[0], rest[1]) if lstm else (rest[0], None)
            else:
                h0 = torch.zeros((n_layers * n_dir, batch, hid),
                                 dtype=x.dtype, device=x.device)
                c0 = torch.zeros_like(h0) if lstm else None
            layer_in, last_h, last_c = x, [], []
            for layer in range(n_layers):
                outs = []
                for d in range(n_dir):
                    k = layer * n_dir + d
                    w = ps[4 * k:4 * k + 4]
                    state = (h0[k], c0[k]) if lstm else (h0[k],)
                    seq = layer_in.unbind(t_axis)
                    ys = []
                    for x_t in (reversed(seq) if d else seq):
                        y, state = step(x_t, state, *w, activation=act)
                        ys.append(y)
                    outs.append(torch.stack(ys[::-1] if d else ys, t_axis))
                    last_h.append(state[0])
                    if lstm:
                        last_c.append(state[1])
                layer_in = outs[0] if n_dir == 1 else torch.cat(outs, -1)
                if p_drop > 0.0 and training and layer < n_layers - 1:
                    layer_in = dropout(layer_in, p_drop)
            if lstm:
                return layer_in, torch.stack(last_h), torch.stack(last_c)
            return layer_in, torch.stack(last_h)

        out = apply_op(self.MODE.lower(), fn, inputs, *params, *extra)
        return (out[0], (out[1], out[2])) if lstm else out


class SimpleRNN(_RNNBase):
    MODE = "RNN_TANH"
    GATES = 1


class LSTM(_RNNBase):
    MODE = "LSTM"
    GATES = 4

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__(input_size, hidden_size, num_layers, direction,
                         time_major, dropout, "tanh", weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr, name)


class GRU(_RNNBase):
    MODE = "GRU"
    GATES = 3

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__(input_size, hidden_size, num_layers, direction,
                         time_major, dropout, "tanh", weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr, name)


class RNNCellBase(Layer):
    """A cell: ``forward(inputs, states) -> (outputs, new_states)``."""

    GATES = 1

    def _make_params(self, input_size, hidden_size, weight_ih_attr,
                     weight_hh_attr, bias_ih_attr, bias_hh_attr):
        g = self.GATES * hidden_size
        init = _uniform(hidden_size)
        self.hidden_size = hidden_size
        self.weight_ih = create_parameter_with_attr(
            [g, input_size], self._dtype, weight_ih_attr, False,
            default_initializer=init)
        self.weight_hh = create_parameter_with_attr(
            [g, hidden_size], self._dtype, weight_hh_attr, False,
            default_initializer=init)
        self.bias_ih = create_parameter_with_attr(
            [g], self._dtype, bias_ih_attr, True, default_initializer=init)
        self.bias_hh = create_parameter_with_attr(
            [g], self._dtype, bias_hh_attr, True, default_initializer=init)

    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        """``[batch, hidden]`` of ``init_value`` (the batch from
        ``batch_ref``'s ``batch_dim_idx``)."""
        from ...core.tensor import to_tensor
        b = batch_ref.shape[batch_dim_idx]
        h = shape[-1] if shape is not None else self.hidden_size
        return to_tensor(np.full((b, h), init_value, dtype or "float32"))

    def _zeros(self, inputs):
        from ...tensor.creation import zeros
        return zeros([inputs.shape[0], self.hidden_size], inputs.dtype)

    def _weights(self):
        return (self.weight_ih, self.weight_hh, self.bias_ih, self.bias_hh)


class SimpleRNNCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__()
        self.activation = activation
        self._make_params(input_size, hidden_size, weight_ih_attr,
                          weight_hh_attr, bias_ih_attr, bias_hh_attr)

    def forward(self, inputs, states=None):
        if states is None:
            states = self._zeros(inputs)
        act = self.activation
        h = apply_op("rnn_cell", lambda x, h, *w: _rnn_step(
            x, (h,), *w, activation=act)[0], inputs, states, *self._weights())
        return h, h


class LSTMCell(RNNCellBase):
    GATES = 4

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self._make_params(input_size, hidden_size, weight_ih_attr,
                          weight_hh_attr, bias_ih_attr, bias_hh_attr)

    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        """``(h, c)``, each as :meth:`RNNCellBase.get_initial_states`."""
        return tuple(super(LSTMCell, self).get_initial_states(
            batch_ref, shape, dtype, init_value, batch_dim_idx)
            for _ in range(2))

    def forward(self, inputs, states=None):
        if states is None:
            z = self._zeros(inputs)
            states = (z, z)
        h, c = apply_op("lstm_cell", lambda x, h, c, *w: _lstm_step(
            x, (h, c), *w)[1], inputs, states[0], states[1],
            *self._weights())
        return h, (h, c)


class GRUCell(RNNCellBase):
    GATES = 3

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self._make_params(input_size, hidden_size, weight_ih_attr,
                          weight_hh_attr, bias_ih_attr, bias_hh_attr)

    def forward(self, inputs, states=None):
        if states is None:
            states = self._zeros(inputs)
        h = apply_op("gru_cell", lambda x, h, *w: _gru_step(
            x, (h,), *w)[0], inputs, states, *self._weights())
        return h, h


class RNN(Layer):
    """A cell run over time, step by step (``is_reverse`` from the last
    step); returns ``(outputs, final states)``."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        from ...tensor.manipulation import stack
        axis = 0 if self.time_major else 1
        steps = range(inputs.shape[axis])
        states, outs = initial_states, []
        for t in (reversed(steps) if self.is_reverse else steps):
            y, states = self.cell(inputs[:, t] if axis else inputs[t],
                                  states)
            outs.append(y)
        return stack(outs[::-1] if self.is_reverse else outs, axis), states


class BiRNN(Layer):
    """A forward and a backward cell over the same input; the outputs
    concatenated, the final states a pair."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, False, time_major)
        self.rnn_bw = RNN(cell_bw, True, time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        from ...tensor.manipulation import concat
        fw0, bw0 = initial_states if initial_states is not None \
            else (None, None)
        out_fw, st_fw = self.rnn_fw(inputs, fw0)
        out_bw, st_bw = self.rnn_bw(inputs, bw0)
        return concat([out_fw, out_bw], axis=-1), (st_fw, st_bw)
