"""The convolutions of the port (``conv1d/2d/3d`` and their transposes,
functionals and layers) against the JAX package's, on the same numpy
inputs and weights: forward and the gradients of the input, the weight and
the bias, float32 within 1e-5 relative and 1e-5 absolute (a convolution
sums its products in another order than XLA's). Includes the string
paddings "SAME"/"VALID" and asymmetric pads (the port refused strings
before), ``Conv2D``'s ``weight_attr``/``bias_attr``/``padding_mode``, and
``output_size`` (honoured by the port, ignored by the reference)."""
import numpy as np
import pytest

from torch_nn_parity import (assert_fn_parity, assert_layer_parity, both,
                             rand)

ATOL = 1e-5


def F(P):
    return P.nn.functional


def _conv(name, x, w, b=None, **kw):
    arrays = [x, w] + ([] if b is None else [b])

    def fn(P, x, w, *b):
        return getattr(F(P), name)(x, w, b[0] if b else None, **kw)
    return fn, arrays


CONVS = {
    "1d": _conv("conv1d", rand(2, 4, 9, seed=1), rand(6, 4, 3, seed=2),
                rand(6, seed=3), stride=2, padding=1),
    "1d_same_nlc": _conv("conv1d", rand(2, 9, 4, seed=1),
                         rand(6, 2, 3, seed=2), padding="SAME", groups=2,
                         data_format="NLC"),
    "1d_pairs_dilation": _conv("conv1d", rand(2, 4, 9, seed=1),
                               rand(6, 4, 3, seed=2), padding=[[1, 2]],
                               dilation=2),
    "2d_same_stride": _conv("conv2d", rand(2, 3, 7, 8, seed=4),
                            rand(5, 3, 3, 2, seed=5), rand(5, seed=6),
                            stride=2, padding="SAME"),
    "2d_valid_nhwc": _conv("conv2d", rand(2, 7, 8, 3, seed=4),
                           rand(5, 3, 3, 3, seed=5), padding="valid",
                           data_format="NHWC"),
    "2d_asym_groups": _conv("conv2d", rand(2, 4, 7, 8, seed=4),
                            rand(6, 2, 3, 3, seed=5), rand(6, seed=6),
                            padding=[0, 1, 2, 1], groups=2),
    "3d": _conv("conv3d", rand(1, 2, 5, 6, 4, seed=7),
                rand(3, 2, 2, 3, 2, seed=8), rand(3, seed=9), padding=1,
                stride=[1, 2, 1]),
    "3d_same_ndhwc": _conv("conv3d", rand(1, 5, 6, 4, 2, seed=7),
                           rand(3, 2, 3, 3, 3, seed=8), padding="SAME",
                           data_format="NDHWC"),
    "1d_transpose": _conv("conv1d_transpose", rand(2, 4, 5, seed=10),
                          rand(4, 3, 3, seed=11), rand(3, seed=12),
                          stride=2, padding=1, output_padding=1),
    "2d_transpose": _conv("conv2d_transpose", rand(2, 4, 4, 5, seed=13),
                          rand(4, 3, 3, 3, seed=14), rand(3, seed=15),
                          stride=2, padding=1),
    "2d_transpose_groups_dilation": _conv(
        "conv2d_transpose", rand(2, 4, 4, 5, seed=13),
        rand(4, 2, 3, 2, seed=14), stride=[2, 1], padding=[1, 0],
        groups=2, dilation=2),
    "2d_transpose_same_nhwc": _conv(
        "conv2d_transpose", rand(2, 4, 5, 4, seed=13),
        rand(4, 3, 3, 3, seed=14), stride=2, padding="SAME",
        data_format="NHWC"),
    "2d_transpose_asym_opad": _conv(
        "conv2d_transpose", rand(1, 2, 3, 4, seed=16),
        rand(2, 3, 3, 3, seed=17), rand(3, seed=18), stride=2,
        padding=[[0, 1], [2, 1]], output_padding=1),
    "3d_transpose": _conv("conv3d_transpose", rand(1, 2, 3, 4, 3, seed=19),
                          rand(2, 3, 2, 3, 2, seed=20), rand(3, seed=21),
                          stride=2, padding=[0, 1, 0]),
}


@pytest.mark.parametrize("case", sorted(CONVS))
def test_conv_functional(case):
    fn, arrays = CONVS[case]
    assert_fn_parity(fn, arrays, grad=tuple(range(len(arrays))), atol=ATOL)


def test_conv_transpose_output_size():
    """``output_size`` sets ``output_padding`` as Paddle does: the size the
    output padding of 1 gives, and the reference's output where that is 0
    (the reference ignores the argument)."""
    jp, tp = both()
    x, w = rand(1, 2, 4, 4, seed=22), rand(2, 3, 3, 3, seed=23)
    F_ = tp.nn.functional
    got = F_.conv2d_transpose(tp.to_tensor(x), tp.to_tensor(w), stride=2,
                              padding=1, output_size=[8, 8]).numpy()
    want = F_.conv2d_transpose(tp.to_tensor(x), tp.to_tensor(w), stride=2,
                               padding=1, output_padding=1).numpy()
    np.testing.assert_array_equal(got, want)
    same = F_.conv2d_transpose(tp.to_tensor(x), tp.to_tensor(w), stride=2,
                               padding=1, output_size=[7, 7]).numpy()
    ref = jp.nn.functional.conv2d_transpose(
        jp.to_tensor(x), jp.to_tensor(w), stride=2, padding=1,
        output_size=[7, 7]).numpy()
    np.testing.assert_allclose(same, ref, rtol=1e-5, atol=ATOL)
    with pytest.raises(ValueError, match="output_size"):
        F_.conv2d_transpose(tp.to_tensor(x), tp.to_tensor(w), stride=2,
                            padding=1, output_size=[10, 10])


LAYERS = [
    ("Conv1D", lambda P: P.nn.Conv1D(4, 6, 3, padding="SAME"),
     rand(2, 4, 9, seed=24)),
    ("Conv2D_attrs", lambda P: P.nn.Conv2D(
        3, 4, 3, stride=2, padding=1,
        weight_attr=P.ParamAttr(learning_rate=0.5), bias_attr=False),
     rand(2, 3, 7, 7, seed=25)),
    ("Conv2D_nhwc_groups", lambda P: P.nn.Conv2D(
        4, 6, [3, 2], groups=2, data_format="NHWC"),
     rand(2, 6, 5, 4, seed=26)),
    ("Conv3D", lambda P: P.nn.Conv3D(2, 3, 2, dilation=2),
     rand(1, 2, 5, 5, 5, seed=27)),
    ("Conv1DTranspose", lambda P: P.nn.Conv1DTranspose(
        4, 2, 3, stride=2, output_padding=1), rand(2, 4, 5, seed=28)),
    ("Conv2DTranspose", lambda P: P.nn.Conv2DTranspose(
        4, 6, 3, stride=2, padding=1, groups=2), rand(2, 4, 3, 4, seed=29)),
    ("Conv3DTranspose", lambda P: P.nn.Conv3DTranspose(
        2, 3, [2, 3, 2], stride=[2, 1, 2]), rand(1, 2, 3, 3, 3, seed=30)),
]


@pytest.mark.parametrize("make,x", [c[1:] for c in LAYERS],
                         ids=[c[0] for c in LAYERS])
def test_conv_layer(make, x):
    jl, tl = assert_layer_parity(make, [x], atol=ATOL)
    assert tl.weight.shape == jl.weight.shape


def test_conv_layer_attrs_and_padding_modes():
    """``weight_attr``/``bias_attr`` initializers and learning rates reach
    the parameters as in the reference; ``padding_mode`` "reflect" pads the
    input first (Paddle's rule; the reference ignores the mode): the JAX
    package's pad then convolution."""
    jp, tp = both()
    layers = {}
    for P in (jp, tp):
        I = P.nn.initializer
        layers[P] = P.nn.Conv2D(
            3, 4, 3, weight_attr=P.ParamAttr(initializer=I.Constant(0.25),
                                             learning_rate=0.1),
            bias_attr=P.ParamAttr(initializer=I.Constant(-0.5)))
    for (n, p), (_, q) in zip(layers[tp].state_dict().items(),
                              layers[jp].state_dict().items()):
        np.testing.assert_array_equal(p.numpy(), q.numpy(), err_msg=n)
    assert layers[tp].weight.optimize_attr["learning_rate"] == 0.1
    x = rand(2, 3, 6, 7, seed=31)
    for mode in ("reflect", "replicate", "circular"):
        conv = tp.nn.Conv2D(3, 4, 3, padding=[1, 2], padding_mode=mode)
        ref = jp.nn.Conv2D(3, 4, 3)
        ref.set_state_dict({k: v.numpy() for k, v in
                            conv.state_dict().items()})
        got = conv(tp.to_tensor(x)).numpy()
        want = ref(jp.nn.functional.pad(jp.to_tensor(x), [2, 2, 1, 1],
                                        mode=mode)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=ATOL,
                                   err_msg=mode)
