"""The recurrent cells of the port (with ``get_initial_states``), ``RNN``
and ``BiRNN``, and beam search (``BeamSearchDecoder`` + ``dynamic_decode``
over an ``LSTMCell``) against the JAX package's, on the same numpy inputs
and weights: outputs, states and gradients float32 within 1e-5 relative and
1e-5 absolute; beam search's ids exactly and its scores within 1e-5."""
import numpy as np
import pytest

from test_torch_api_nn_rnn import ATOL, B, H, IN, _x
from torch_nn_parity import assert_layer_parity, both, rand
from torch_threads import two_intra_op_threads  # noqa: F401 (autouse)


CELLS = [("SimpleRNNCell", 1), ("LSTMCell", 2), ("GRUCell", 1)]


@pytest.mark.parametrize("name,n_states", CELLS,
                         ids=[c[0] for c in CELLS])
def test_cell(name, n_states):
    arrays = [rand(B, IN, seed=4)] + [rand(B, H, seed=5 + i)
                                      for i in range(n_states)]

    def call(cell, x, *states):
        return cell(x, tuple(states) if n_states == 2 else states[0])
    assert_layer_parity(lambda P: getattr(P.nn, name)(IN, H), arrays,
                        grad=tuple(range(len(arrays))), call=call, atol=ATOL)
    assert_layer_parity(lambda P: getattr(P.nn, name)(IN, H), arrays[:1],
                        atol=ATOL)


def test_cell_initial_states():
    jp, tp = both()
    for P in (tp, jp):
        ref = P.to_tensor(np.zeros((B, IN), np.float32))
        h = P.nn.GRUCell(IN, H).get_initial_states(ref, init_value=0.5)
        h2, c2 = P.nn.LSTMCell(IN, H).get_initial_states(ref)
        assert h.shape == [B, H] and float(h.numpy().mean()) == 0.5
        assert c2.shape == [B, H] and not c2.numpy().any()
        assert isinstance(P.nn.GRUCell(IN, H), P.nn.RNNCellBase)


@pytest.mark.parametrize("kind", ["rnn", "rnn_reverse_time_major", "birnn"])
def test_rnn_and_birnn_wrappers(kind):
    tm = kind == "rnn_reverse_time_major"
    x = _x(tm)

    def make(P):
        if kind == "birnn":
            return P.nn.BiRNN(P.nn.LSTMCell(IN, H), P.nn.GRUCell(IN, H))
        return P.nn.RNN(P.nn.SimpleRNNCell(IN, H), is_reverse=tm,
                        time_major=tm)
    assert_layer_parity(make, [x], atol=ATOL)


def _decode(P, cell_state, steps):
    cell = P.nn.LSTMCell(IN, H)
    cell.set_state_dict(cell_state)
    emb = P.nn.Embedding(9, IN)
    emb.set_state_dict({"weight": rand(9, IN, seed=6)})
    out = P.nn.Linear(H, 9)
    out.set_state_dict({"weight": rand(H, 9, seed=7, lo=-2, hi=2),
                        "bias": rand(9, seed=8)})
    dec = P.nn.BeamSearchDecoder(cell, start_token=0, end_token=1,
                                 beam_size=3, embedding_fn=emb,
                                 output_fn=out)
    ref = P.to_tensor(np.zeros((2, IN), np.float32))
    return P.nn.dynamic_decode(dec, inits=cell.get_initial_states(ref),
                               max_step_num=steps)


def test_beam_search_against_jax():
    jp, tp = both()
    state = {k: v.numpy() for k, v in jp.nn.LSTMCell(
        IN, H).state_dict().items()}
    (tid, tsc), (jid, jsc) = _decode(tp, state, 6), _decode(jp, state, 6)
    np.testing.assert_array_equal(tid.numpy(), jid.numpy())
    np.testing.assert_allclose(tsc.numpy(), jsc.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert tid.shape[0] == 2 and tid.shape[2] == 3
