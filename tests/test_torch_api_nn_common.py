"""The common functionals of the port (``nn/functional/common.py``)
against the JAX package's, on the same numpy inputs: forward and the
gradient of every floating input, float32 within 1e-5 relative and 1e-6
absolute (``torch_nn_parity``). ``interpolate`` is held to the reference
where the two compute the same function (nearest; linear upsampling with
half-pixel centres); ``test_torch_api_nn_common_layers.py`` pins the
rest."""
import numpy as np
import pytest

from torch_nn_parity import assert_fn_parity, rand
from torch_threads import two_intra_op_threads  # noqa: F401 (autouse)

X4 = rand(2, 4, 5, 6, seed=1)          # NCHW
X3 = rand(2, 3, 7, seed=2)             # NCL
X5 = rand(1, 2, 3, 4, 5, seed=3)       # NCDHW


def F(P):
    return P.nn.functional


FNS = [
    ("one_hot", lambda P, i: F(P).one_hot(i, 5),
     [np.array([0, 4, 2, 7, -1], np.int64)]),
    ("label_smooth", lambda P, y: F(P).label_smooth(y, epsilon=0.2),
     [np.eye(4, dtype=np.float32)[[0, 3, 1]]]),
    ("label_smooth_prior", lambda P, y, p: F(P).label_smooth(y, p, 0.1),
     [np.eye(4, dtype=np.float32)[[0, 3, 1]],
      np.array([[0.1, 0.2, 0.3, 0.4]], np.float32)]),
    ("cosine_similarity", lambda P, a, b: F(P).cosine_similarity(a, b),
     [X4, rand(2, 4, 5, 6, seed=4)]),
    ("cosine_similarity_last", lambda P, a, b: F(P).cosine_similarity(
        a, b, axis=-1), [X4, rand(2, 4, 5, 6, seed=4)]),
    ("bilinear", lambda P, a, b, w, c: F(P).bilinear(a, b, w, c),
     [rand(3, 4, seed=5), rand(3, 5, seed=6), rand(2, 4, 5, seed=7),
      rand(2, seed=8)]),
    ("pixel_shuffle", lambda P, x: F(P).pixel_shuffle(x, 2),
     [rand(2, 8, 3, 3, seed=9)]),
    ("pixel_shuffle_nhwc", lambda P, x: F(P).pixel_shuffle(x, 2, "NHWC"),
     [rand(2, 3, 3, 8, seed=9)]),
    ("pixel_unshuffle", lambda P, x: F(P).pixel_unshuffle(x, 2),
     [rand(2, 2, 4, 6, seed=10)]),
    ("pixel_unshuffle_nhwc", lambda P, x: F(P).pixel_unshuffle(
        x, 2, "NHWC"), [rand(2, 4, 6, 2, seed=10)]),
    ("channel_shuffle", lambda P, x: F(P).channel_shuffle(x, 2), [X4]),
    ("channel_shuffle_nhwc", lambda P, x: F(P).channel_shuffle(
        x, 3, "NHWC"), [rand(2, 3, 3, 6, seed=11)]),
    ("nearest_up", lambda P, x: F(P).interpolate(x, scale_factor=2), [X4]),
    ("nearest_down", lambda P, x: F(P).interpolate(x, size=[3, 4]), [X4]),
    ("nearest_nhwc", lambda P, x: F(P).interpolate(
        x, size=[7, 9], data_format="NHWC"), [rand(2, 5, 6, 3, seed=12)]),
    ("nearest_1d", lambda P, x: F(P).interpolate(
        x, size=11, data_format="NCW"), [X3]),
    ("nearest_3d", lambda P, x: F(P).interpolate(
        x, scale_factor=2, data_format="NCDHW"), [X5]),
    ("bilinear_up", lambda P, x: F(P).interpolate(
        x, size=[9, 13], mode="bilinear"), [X4]),
    ("bilinear_up_nhwc", lambda P, x: F(P).interpolate(
        x, scale_factor=2, mode="bilinear", data_format="NHWC"),
     [rand(2, 5, 6, 3, seed=13)]),
    ("linear_up", lambda P, x: F(P).interpolate(
        x, size=16, mode="linear", data_format="NCW"), [X3]),
    ("trilinear_up", lambda P, x: F(P).interpolate(
        x, scale_factor=2, mode="trilinear", data_format="NCDHW"), [X5]),
    ("upsample", lambda P, x: F(P).upsample(x, scale_factor=3), [X4]),
    ("unfold", lambda P, x: F(P).unfold(x, 3), [X4]),
    ("unfold_pad2_stride", lambda P, x: F(P).unfold(
        x, [2, 3], strides=2, paddings=[1, 2], dilations=[1, 2]), [X4]),
    ("unfold_pad4", lambda P, x: F(P).unfold(x, 2, paddings=[1, 0, 2, 1]),
     [X4]),
    ("fold", lambda P, x: F(P).fold(x, [4, 5], 2), [rand(2, 12, 12, seed=14)]),
    ("fold_stride_pad", lambda P, x: F(P).fold(
        x, [5, 6], [2, 3], strides=2, paddings=1), [rand(1, 12, 9,
                                                         seed=15)]),
    ("pad_constant", lambda P, x: F(P).pad(x, [1, 2, 0, 1], value=0.5),
     [X4]),
    ("pad_reflect", lambda P, x: F(P).pad(x, [1, 2, 2, 1], mode="reflect"),
     [X4]),
    ("pad_replicate_nhwc", lambda P, x: F(P).pad(
        x, [1, 1, 2, 0], mode="replicate", data_format="NHWC"), [X4]),
    ("pad_circular_1d", lambda P, x: F(P).pad(
        x, [2, 1], mode="circular", data_format="NCL"), [X3]),
    ("zeropad2d", lambda P, x: F(P).zeropad2d(x, [1, 0, 2, 1]), [X4]),
    ("temporal_shift", lambda P, x: F(P).temporal_shift(x, 2, 0.25),
     [rand(4, 8, 3, 3, seed=16)]),
    ("temporal_shift_nhwc", lambda P, x: F(P).temporal_shift(
        x, 3, 0.25, "NHWC"), [rand(6, 2, 2, 8, seed=17)]),
    ("grid_sample", lambda P, x, g: F(P).grid_sample(x, g),
     [X4, rand(2, 3, 4, 2, seed=18, lo=-1.2, hi=1.2)]),
    ("grid_sample_no_align", lambda P, x, g: F(P).grid_sample(
        x, g, align_corners=False),
     [X4, rand(2, 3, 4, 2, seed=19, lo=-1.2, hi=1.2)]),
    ("grid_sample_nearest", lambda P, x, g: F(P).grid_sample(
        x, g, mode="nearest"), [X4, rand(2, 3, 4, 2, seed=20, lo=-0.9,
                                         hi=0.9)]),
    ("affine_grid", lambda P, t: F(P).affine_grid(t, [2, 3, 4, 5]),
     [rand(2, 2, 3, seed=21)]),
    ("affine_grid_no_align", lambda P, t: F(P).affine_grid(
        t, [2, 3, 4, 5], align_corners=False), [rand(2, 2, 3, seed=21)]),
    ("sequence_mask", lambda P, n: F(P).sequence_mask(n),
     [np.array([3, 0, 5], np.int64)]),
    ("sequence_mask_maxlen", lambda P, n: F(P).sequence_mask(
        n, 6, "float32"), [np.array([[3, 1], [5, 6]], np.int64)]),
    ("pairwise_distance", lambda P, a, b: F(P).pairwise_distance(a, b),
     [rand(4, 6, seed=22), rand(4, 6, seed=23)]),
    ("pairwise_distance_p1_keepdim", lambda P, a, b: F(P).pairwise_distance(
        a, b, p=1.0, keepdim=True), [rand(4, 6, seed=22),
                                     rand(4, 6, seed=23)]),
    ("pairwise_distance_inf", lambda P, a, b: F(P).pairwise_distance(
        a, b, p=float("inf")), [rand(4, 6, seed=22), rand(4, 6, seed=23)]),
    ("gather_tree", lambda P, i, p: F(P).gather_tree(i, p),
     [np.random.RandomState(24).randint(0, 9, (5, 2, 3)).astype(np.int64),
      np.random.RandomState(25).randint(0, 3, (5, 2, 3)).astype(np.int64)]),
]


@pytest.mark.parametrize("fn,arrays", [c[1:] for c in FNS],
                         ids=[c[0] for c in FNS])
def test_common_functional(fn, arrays):
    grad = tuple(i for i, a in enumerate(arrays) if a.dtype == np.float32)
    assert_fn_parity(fn, arrays, grad=grad)
