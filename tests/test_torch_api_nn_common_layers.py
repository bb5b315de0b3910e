"""The common layers of the port (``nn/layer/common.py``) and
``sparse_attention`` against the JAX package's, on the same numpy inputs:
forward and the gradient of every floating input and parameter, float32
within 1e-5 relative and 1e-6 absolute (``torch_nn_parity``).

Where the port computes Paddle's function and the reference another
(ROADMAP queue 3), the port is pinned to its own result: ``interpolate``
with ``align_corners``/``align_mode`` and linear downsampling against a
numpy version of Paddle's formula, "area" against an adaptive average pool,
``grid_sample``'s ``padding_mode``. The dropout masks come from different
generators in the two packages, so the dropouts are held to their rule."""
import numpy as np
import pytest

from test_torch_api_nn_common import F, X3, X4, X5
from torch_nn_parity import (assert_fn_parity, assert_layer_parity, both,
                             rand)


@pytest.mark.parametrize("batched", [True, False])
def test_sparse_attention(batched):
    """Masked dense attention from a CSR pattern (per batch and head, or one
    for all), with a key padding mask and an additive mask."""
    rs = np.random.RandomState(26)
    b, h, s, d = 2, 2, 5, 4
    q, k, v = (rand(b, h, s, d, seed=27 + i) for i in range(3))
    allow = rs.rand(b, h, s, s) < 0.6
    allow[..., np.arange(s), np.arange(s)] = True
    if not batched:
        allow = allow[0, 0]
    offs = np.concatenate([np.zeros(allow.shape[:-2] + (1,), np.int64),
                           np.cumsum(allow.sum(-1), -1)], -1)
    cols = np.zeros(allow.shape[:-2] + (int(allow.sum(-1).sum(-1).max()),),
                    np.int64)
    for idx in np.ndindex(allow.shape[:-2]):
        c = np.nonzero(allow[idx])[1]
        cols[idx][:len(c)] = c
    kpm = np.array([[1, 1, 1, 1, 0], [1, 1, 1, 0, 0]], np.float32)
    am = rand(s, s, seed=30)

    def fn(P, q, k, v, kp, m):
        return F(P).sparse_attention(q, k, v, P.to_tensor(offs),
                                     P.to_tensor(cols), key_padding_mask=kp,
                                     attn_mask=m)
    assert_fn_parity(fn, [q, k, v, kpm, am], grad=(0, 1, 2))


def _paddle_linear(x, out_sp, align_corners, align_mode):
    """Paddle's linear resize in numpy (``interpolate_kernel``), separable
    over the trailing axes."""
    for i, n_out in enumerate(out_sp):
        ax = x.ndim - len(out_sp) + i
        n_in = x.shape[ax]
        d = np.arange(n_out, dtype=np.float64)
        if align_corners:
            src = d * ((n_in - 1) / (n_out - 1))
        elif align_mode == 0:
            src = np.maximum((d + 0.5) * (n_in / n_out) - 0.5, 0)
        else:
            src = d * (n_in / n_out)
        i0 = np.minimum(np.floor(src).astype(int), n_in - 1)
        i1 = np.minimum(i0 + 1, n_in - 1)
        lam = (src - i0).reshape([-1 if j == ax else 1
                                  for j in range(x.ndim)])
        x = np.take(x, i0, ax) * (1 - lam) + np.take(x, i1, ax) * lam
    return x.astype(np.float32)


@pytest.mark.parametrize("size,ac,mode", [
    ([9, 13], True, 0), ([9, 13], False, 1), ([3, 4], False, 0),
    ([3, 4], True, 0)], ids=["up_corners", "up_mode1", "down", "down_corners"])
def test_interpolate_paddle_formula(size, ac, mode):
    """Where the reference ignores ``align_corners``/``align_mode`` or
    antialiases (downsampling), the port gives Paddle's formula; it differs
    from the reference there."""
    jp, tp = both()
    got = tp.nn.functional.interpolate(
        tp.to_tensor(X4), size=size, mode="bilinear", align_corners=ac,
        align_mode=mode).numpy()
    np.testing.assert_allclose(got, _paddle_linear(X4.astype(np.float64),
                                                   size, ac, mode),
                               rtol=1e-5, atol=1e-6)
    ref = jp.nn.functional.interpolate(jp.to_tensor(X4), size=size,
                                       mode="bilinear", align_corners=ac,
                                       align_mode=mode).numpy()
    assert not np.allclose(got, ref, atol=1e-4)


def test_interpolate_area_bicubic_and_nearest_corners():
    """"area" is an adaptive average pool; "nearest" with ``align_corners``
    takes the rounded corner-aligned index; "bicubic" keeps the input where
    the grid does (corner-aligned, integer scale)."""
    _, tp = both()
    F_ = tp.nn.functional
    x = tp.to_tensor(X4)
    area = F_.interpolate(x, size=[2, 3], mode="area").numpy()
    np.testing.assert_allclose(
        area, F_.adaptive_avg_pool2d(x, [2, 3]).numpy(), rtol=1e-6)
    near = F_.interpolate(x, size=[9, 11], align_corners=True).numpy()
    ih = np.floor(np.arange(9) * (4 / 8) + 0.5).astype(int)
    iw = np.floor(np.arange(11) * (5 / 10) + 0.5).astype(int)
    np.testing.assert_array_equal(near, X4[:, :, ih][:, :, :, iw])
    cub = F_.interpolate(x, size=[9, 11], mode="bicubic",
                         align_corners=True).numpy()
    np.testing.assert_allclose(cub[:, :, ::2, ::2], X4, rtol=1e-5, atol=1e-6)


def test_grid_sample_padding_modes():
    """The port honours ``padding_mode`` as Paddle does (the reference
    always pads with zeros): "border" equals sampling at the coordinates
    clamped to [-1, 1] (corner-aligned)."""
    jp, tp = both()
    g = rand(2, 3, 4, 2, seed=31, lo=-1.5, hi=1.5)
    F_ = tp.nn.functional
    border = F_.grid_sample(tp.to_tensor(X4), tp.to_tensor(g),
                            padding_mode="border").numpy()
    clamped = F_.grid_sample(tp.to_tensor(X4),
                             tp.to_tensor(np.clip(g, -1, 1))).numpy()
    np.testing.assert_allclose(border, clamped, rtol=1e-6, atol=1e-6)
    ref = jp.nn.functional.grid_sample(jp.to_tensor(X4), jp.to_tensor(g),
                                       padding_mode="border").numpy()
    assert not np.allclose(border, ref, atol=1e-4)


def test_class_center_sample_raises_as_the_reference():
    jp, tp = both()
    for P in (jp, tp):
        with pytest.raises(NotImplementedError, match="PS-style API"):
            P.nn.functional.class_center_sample(None, 10, 4)


@pytest.mark.parametrize("kind", ["dropout2d", "dropout3d", "alpha"])
def test_dropouts(kind):
    """Outside training (or at p=0) the identity, as the reference; in
    training ``dropout2d``/``3d`` zero whole channels and scale the rest by
    1 / (1 - p), and ``alpha_dropout`` maps each element to ``a·x + b`` or
    to ``a·α' + b``."""
    jp, tp = both()
    F_ = tp.nn.functional
    x = {"dropout2d": rand(8, 16, 3, 3, seed=32),
         "dropout3d": rand(8, 16, 2, 2, 2, seed=33),
         "alpha": rand(64, 64, seed=34)}[kind]
    fn = {"dropout2d": F_.dropout2d, "dropout3d": F_.dropout3d,
          "alpha": F_.alpha_dropout}[kind]
    jfn = getattr(jp.nn.functional, fn.__name__)
    for training, p in ((False, 0.3), (True, 0.0)):
        np.testing.assert_array_equal(
            fn(tp.to_tensor(x), p=p, training=training).numpy(),
            jfn(jp.to_tensor(x), p=p, training=training).numpy())
    tp.seed(7)
    y = fn(tp.to_tensor(x), p=0.4).numpy()
    if kind == "alpha":
        ap = -1.6732632423543772 * 1.0507009873554805
        a = (0.6 + ap ** 2 * 0.6 * 0.4) ** -0.5
        b = -a * ap * 0.4
        kept = np.isclose(y, a * x + b, rtol=1e-5, atol=1e-6)
        assert (kept | np.isclose(y, a * ap + b)).all()
        assert 0.5 < kept.mean() < 0.7
        return
    flat = y.reshape(x.shape[0], x.shape[1], -1)
    zero = (flat == 0).all(-1)
    np.testing.assert_allclose(flat[~zero], x.reshape(flat.shape)[~zero]
                               / 0.6, rtol=1e-6)
    assert 0.2 < zero.mean() < 0.6


LAYERS = [
    ("Upsample", lambda P: P.nn.Upsample(scale_factor=2), [X4]),
    ("UpsamplingNearest2D", lambda P: P.nn.UpsamplingNearest2D(size=[7, 8]),
     [X4]),
    ("Bilinear", lambda P: P.nn.Bilinear(4, 5, 3),
     [rand(3, 4, seed=35), rand(3, 5, seed=36)]),
    ("PixelShuffle", lambda P: P.nn.PixelShuffle(2),
     [rand(2, 8, 3, 3, seed=9)]),
    ("PixelUnshuffle", lambda P: P.nn.PixelUnshuffle(2),
     [rand(2, 2, 4, 6, seed=10)]),
    ("ChannelShuffle", lambda P: P.nn.ChannelShuffle(2), [X4]),
    ("CosineSimilarity", lambda P: P.nn.CosineSimilarity(axis=2),
     [X4, rand(2, 4, 5, 6, seed=37)]),
    ("Pad1D", lambda P: P.nn.Pad1D([1, 2], mode="reflect"), [X3]),
    ("Pad2D", lambda P: P.nn.Pad2D([1, 0, 2, 1], value=0.3), [X4]),
    ("Pad3D", lambda P: P.nn.Pad3D([1, 1, 0, 1, 2, 0], mode="replicate"),
     [X5]),
    ("ZeroPad2D", lambda P: P.nn.ZeroPad2D([1, 1, 0, 2]), [X4]),
    ("Unfold", lambda P: P.nn.Unfold([2, 2], strides=2), [X4]),
    ("Fold", lambda P: P.nn.Fold([4, 5], 2), [rand(2, 12, 12, seed=14)]),
    ("PairwiseDistance", lambda P: P.nn.PairwiseDistance(p=3.0),
     [rand(4, 6, seed=22), rand(4, 6, seed=23)]),
    ("Dropout2D_eval", lambda P: P.nn.Dropout2D(0.5), [X4]),
    ("Dropout3D_eval", lambda P: P.nn.Dropout3D(0.5), [X5]),
    ("AlphaDropout_eval", lambda P: P.nn.AlphaDropout(0.5), [X4]),
]


@pytest.mark.parametrize("make,arrays", [c[1:] for c in LAYERS],
                         ids=[c[0] for c in LAYERS])
def test_common_layer(make, arrays):
    assert_layer_parity(make, arrays, grad=tuple(range(len(arrays))),
                        train=False)


def test_upsampling_bilinear_2d_is_corner_aligned():
    """``UpsamplingBilinear2D`` is corner-aligned bilinear (Paddle's
    formula; the reference ignores ``align_corners``)."""
    _, tp = both()
    got = tp.nn.UpsamplingBilinear2D(size=[9, 11])(tp.to_tensor(X4)).numpy()
    np.testing.assert_allclose(got, _paddle_linear(
        X4.astype(np.float64), [9, 11], True, 0), rtol=1e-5, atol=1e-6)


def test_nn_utils_and_pad_quirks():
    """``parameters_to_vector``/``vector_to_parameters`` as the reference's;
    ``weight_norm``, ``remove_weight_norm`` and ``spectral_norm`` return
    the layer unchanged in both (the reference's no-ops, copied); an int
    padding fails in both packages' ``pad``."""
    jp, tp = both()
    vecs = {}
    for P in (jp, tp):
        lin = P.nn.Linear(3, 2)
        lin.set_state_dict({"weight": rand(3, 2, seed=40),
                            "bias": rand(2, seed=41)})
        vec = P.nn.utils.parameters_to_vector(lin.parameters())
        vecs[P] = vec.numpy()
        P.nn.utils.vector_to_parameters(vec * 2, lin.parameters())
        np.testing.assert_allclose(lin.bias.numpy(), rand(2, seed=41) * 2)
        for fn in (P.nn.utils.weight_norm, P.nn.utils.remove_weight_norm,
                   P.nn.utils.spectral_norm):
            assert fn(lin) is lin
        with pytest.raises(TypeError):
            P.nn.functional.pad(P.to_tensor(X4), 1)
    np.testing.assert_array_equal(vecs[tp], vecs[jp])
    assert tp.nn.utils_helpers.utils.weight_norm is tp.nn.utils.weight_norm
