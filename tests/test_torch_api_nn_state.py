"""Weights across: each new layer's parameters and buffers (the RNNs' four
tensors a layer and direction, the batch norm's ``_mean``/``_variance``,
the instance norm's ``scale``/``bias``, the transposed convolutions'
``[in, out / groups, k…]`` weights, the transformer's projections) written
with ``paddle.save`` by one package load into the other's layer by the same
names, in both directions, and give the writer's outputs (eval, float32
within 1e-5 relative and 1e-6 absolute)."""
import numpy as np
import pytest

from torch_nn_parity import both, rand

LAYERS = {
    "lstm_bidirect_2": (lambda P: P.nn.LSTM(4, 5, 2, "bidirect"),
                        rand(2, 3, 4, seed=1)),
    "gru": (lambda P: P.nn.GRU(4, 5), rand(2, 3, 4, seed=2)),
    "batch_norm_2d": (lambda P: P.nn.BatchNorm2D(3), rand(2, 3, 4, 4,
                                                          seed=3)),
    "instance_norm_2d": (lambda P: P.nn.InstanceNorm2D(3),
                         rand(2, 3, 4, 4, seed=4)),
    "conv2d_transpose": (lambda P: P.nn.Conv2DTranspose(4, 6, 3, 2,
                                                        groups=2),
                         rand(1, 4, 3, 3, seed=5)),
    "conv1d": (lambda P: P.nn.Conv1D(3, 2, 3, padding="SAME"),
               rand(2, 3, 6, seed=6)),
    "transformer": (lambda P: P.nn.Transformer(8, 2, 1, 1, 16, 0.0),
                    (rand(2, 5, 8, seed=7), rand(2, 3, 8, seed=8))),
    "bilinear": (lambda P: P.nn.Bilinear(3, 4, 2),
                 (rand(2, 3, seed=9), rand(2, 4, seed=10))),
}


def _forward(P, layer, x):
    xs = x if isinstance(x, tuple) else (x,)
    out = layer(*[P.to_tensor(a) for a in xs])
    while isinstance(out, (tuple, list)):
        out = out[0]
    return out.numpy()


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("name", sorted(LAYERS))
def test_save_in_one_package_load_in_the_other(tmp_path, name, writer):
    jp, tp = both()
    src, dst = (tp, jp) if writer == "port" else (jp, tp)
    make, x = LAYERS[name]
    a, b = make(src), make(dst)
    if name == "batch_norm_2d":             # move the running statistics
        a(src.to_tensor(x * 2 + 1))
    a.eval()
    b.eval()
    path = str(tmp_path / "layer.pdparams")
    src.save(a.state_dict(), path)
    sd = dst.load(path)
    assert list(sd) == list(a.state_dict())
    missing, unexpected = b.set_state_dict(sd)
    assert not missing and not unexpected
    np.testing.assert_allclose(_forward(dst, b, x), _forward(src, a, x),
                               rtol=1e-5, atol=1e-6)
