"""The recurrent layers of the port (``SimpleRNN``, ``LSTM``, ``GRU`` with
layers, directions and ``time_major``) against the JAX package's, on the
same numpy inputs and weights (carried by state dict under the reference's
names, ``weight_ih_l{k}[_reverse]`` and the rest): outputs, final states
and the gradients of the input, the initial states and every parameter,
float32 within 1e-5 relative and 1e-5 absolute (a time loop compounds
rounding). ``test_torch_api_nn_rnn_cells.py`` holds the cells, ``RNN``,
``BiRNN`` and beam search."""
import numpy as np
import pytest

from torch_nn_parity import (assert_layer_parity, both, carry_state, rand)
from torch_threads import two_intra_op_threads  # noqa: F401 (autouse)

ATOL = 1e-5
B, T, IN, H = 3, 5, 4, 6


def _x(time_major=False):
    x = rand(B, T, IN, seed=1)
    return x.transpose(1, 0, 2).copy() if time_major else x


CASES = [
    ("SimpleRNN", {}, False), ("SimpleRNN", {"activation": "relu"}, False),
    ("LSTM", {}, False), ("GRU", {}, False),
    ("LSTM", {"num_layers": 2, "direction": "bidirect"}, False),
    ("GRU", {"num_layers": 2, "direction": "bidirectional"}, False),
    ("SimpleRNN", {"num_layers": 2, "time_major": True}, False),
    ("LSTM", {"direction": "bidirect", "time_major": True}, True),
    ("GRU", {"num_layers": 2}, True),
]


@pytest.mark.parametrize("mode,kw,init", [c for c in CASES],
                         ids=[f"{m}{i}" for i, (m, _, _) in enumerate(CASES)])
def test_rnn_layer(mode, kw, init):
    tm = kw.get("time_major", False)
    n_states = kw.get("num_layers", 1) * (2 if "direction" in kw else 1)
    arrays = [_x(tm)]
    if init:
        arrays += [rand(n_states, B, H, seed=2)] + (
            [rand(n_states, B, H, seed=3)] if mode == "LSTM" else [])

    def call(layer, x, *states):
        if not states:
            return layer(x)
        return layer(x, tuple(states) if mode == "LSTM" else states[0])
    jl, tl = assert_layer_parity(
        lambda P: getattr(P.nn, mode)(IN, H, **kw), arrays,
        grad=tuple(range(len(arrays))), call=call, atol=ATOL)
    names = [n for n, _ in tl.named_parameters()]
    assert names[:4] == ["weight_ih_l0", "weight_hh_l0", "bias_ih_l0",
                         "bias_hh_l0"]


def test_rnn_dropout_between_layers_and_sequence_length():
    """``dropout`` drops the outputs between stacked layers in training
    only (the reference ignores it): eval equals the reference; training
    differs from eval. ``sequence_length`` is ignored, as the
    reference's."""
    jp, tp = both()
    jl = jp.nn.LSTM(IN, H, num_layers=2, dropout=0.5)
    tl = tp.nn.LSTM(IN, H, num_layers=2, dropout=0.5)
    carry_state(jl, tl)
    x = _x()
    tl.eval()
    jl.eval()
    ev = tl(tp.to_tensor(x))[0].numpy()
    np.testing.assert_allclose(ev, jl(jp.to_tensor(x))[0].numpy(),
                               rtol=1e-5, atol=ATOL)
    tl.train()
    assert not np.allclose(tl(tp.to_tensor(x))[0].numpy(), ev)
    tl.eval()
    lens = tp.to_tensor(np.array([5, 2, 3], np.int64))
    np.testing.assert_array_equal(
        tl(tp.to_tensor(x), sequence_length=lens)[0].numpy(), ev)
