"""The loss functionals and loss layers of the port against the JAX
package's, on the same numpy inputs: forward and the gradient of every
floating input (and of the layers' parameters), float32 within 1e-5
relative and 1e-6 absolute (``torch_nn_parity.RTOL``/``ATOL``; CTC and RNN-T
within 1e-5 absolute, their sums run in another order). Also
``cross_entropy``'s class weights, soft labels, label smoothing, other axes
and ``use_softmax=False``, which the port refused before."""
import numpy as np
import pytest

from torch_nn_parity import assert_fn_parity, rand

N, C = 6, 5
LOGITS = rand(N, C, seed=1, lo=-3, hi=3)
LABELS = np.array([0, 4, -100, 2, 1, 3], np.int64)
LAB = np.array([0, 4, 1, 2, 1, 3], np.int64)
W = rand(C, seed=2, lo=0.5, hi=1.5)
SOFT = np.exp(LOGITS[::-1].copy()) / np.exp(LOGITS[::-1]).sum(
    -1, keepdims=True)
PROBS = rand(N, C, seed=3, lo=0.05, hi=0.95)
BIN = (rand(N, C, seed=4) > 0).astype(np.float32)
PM1 = np.where(rand(N, seed=5) > 0, 1.0, -1.0).astype(np.float32)
X3 = rand(2, C, 7, seed=6, lo=-2, hi=2)
LAB3 = np.random.RandomState(7).randint(0, C, (2, 7)).astype(np.int64)
A, B_, D = rand(N, 8, seed=8), rand(N, 8, seed=9), rand(N, 8, seed=10)


def F(P):
    return P.nn.functional


CE = [
    ("hard_mean", {}, LABELS), ("hard_sum", {"reduction": "sum"}, LABELS),
    ("hard_none", {"reduction": "none"}, LABELS),
    ("trailing_dim", {}, LAB[:, None]),
    ("weight_mean", {"use_weight": True}, LABELS),
    ("weight_sum", {"use_weight": True, "reduction": "sum"}, LABELS),
    ("weight_none", {"use_weight": True, "reduction": "none"}, LABELS),
    ("smooth_mean", {"label_smoothing": 0.1}, LABELS),
    ("smooth_none", {"label_smoothing": 0.2, "reduction": "none"}, LABELS),
    ("smooth_weight", {"label_smoothing": 0.1, "use_weight": True}, LABELS),
    ("soft", {"soft_label": True}, SOFT),
    ("soft_smooth_sum", {"soft_label": True, "label_smoothing": 0.1,
                         "reduction": "sum"}, SOFT),
    ("no_softmax", {"use_softmax": False}, LAB),
    ("ignore_index_1", {"ignore_index": 1}, LAB),
]


@pytest.mark.parametrize("kw,label", [c[1:] for c in CE],
                         ids=[c[0] for c in CE])
def test_cross_entropy_options(kw, label):
    kw = dict(kw)
    use_w = kw.pop("use_weight", False)
    x = PROBS if kw.get("use_softmax") is False else LOGITS

    def fn(P, x, y, *w):
        return F(P).cross_entropy(x, y, weight=w[0] if w else None, **kw)
    arrays = [x, label] + ([W] if use_w else [])
    assert_fn_parity(fn, arrays, grad=(0,))


@pytest.mark.parametrize("kw", [{}, {"reduction": "none"},
                                {"label_smoothing": 0.1}],
                         ids=["mean", "none", "smooth"])
def test_cross_entropy_other_axis(kw):
    assert_fn_parity(lambda P, x, y: F(P).cross_entropy(x, y, axis=1, **kw),
                     [X3, LAB3], grad=(0,))


@pytest.mark.parametrize("kw,label", [({}, LAB[:, None]),
                                      ({"soft_label": True}, SOFT),
                                      ({"return_softmax": True}, LAB[:, None]),
                                      ({"axis": 1}, LAB3[:, None])],
                         ids=["hard", "soft", "return_softmax", "axis1"])
def test_softmax_with_cross_entropy(kw, label):
    x = X3 if kw.get("axis") == 1 else LOGITS
    assert_fn_parity(lambda P, x, y: F(P).softmax_with_cross_entropy(
        x, y, **kw), [x, label], grad=(0,))


def _logp():
    return LOGITS - np.log(np.exp(LOGITS).sum(-1, keepdims=True))


LOSSES = [
    ("nll_mean", lambda P, x, y: F(P).nll_loss(x, y), [_logp(), LABELS]),
    ("nll_weight", lambda P, x, y, w: F(P).nll_loss(x, y, w),
     [_logp(), LABELS, W]),
    ("nll_sum", lambda P, x, y: F(P).nll_loss(x, y, reduction="sum"),
     [_logp(), LAB]),
    ("bce", lambda P, p, y: F(P).binary_cross_entropy(p, y), [PROBS, BIN]),
    ("bce_weight_none", lambda P, p, y, w: F(P).binary_cross_entropy(
        p, y, w, reduction="none"), [PROBS, BIN, W]),
    ("bce_logits", lambda P, z, y: F(P).binary_cross_entropy_with_logits(
        z, y), [LOGITS, BIN]),
    ("bce_logits_weights", lambda P, z, y, w, pw:
     F(P).binary_cross_entropy_with_logits(z, y, w, "sum", pw),
     [LOGITS, BIN, W, W[::-1].copy()]),
    ("mse", lambda P, a, b: F(P).mse_loss(a, b), [A, B_]),
    ("l1_sum", lambda P, a, b: F(P).l1_loss(a, b, "sum"), [A, B_]),
    ("smooth_l1", lambda P, a, b: F(P).smooth_l1_loss(a, b, delta=0.5),
     [A, B_]),
    ("kl_div", lambda P, lp, y: F(P).kl_div(lp, y), [_logp(), SOFT]),
    ("kl_div_batchmean", lambda P, lp, y: F(P).kl_div(lp, y, "batchmean"),
     [_logp(), SOFT]),
    ("margin_ranking", lambda P, a, b, y: F(P).margin_ranking_loss(
        a, b, y, margin=0.1), [A[:, 0].copy(), B_[:, 0].copy(), PM1]),
    ("hinge_embedding", lambda P, a, y: F(P).hinge_embedding_loss(
        a, y, margin=0.5), [A[:, 0].copy(), PM1]),
    ("cosine_embedding", lambda P, a, b, y: F(P).cosine_embedding_loss(
        a, b, y, margin=0.1), [A, B_, PM1]),
    ("triplet", lambda P, a, p, n: F(P).triplet_margin_loss(a, p, n),
     [A, B_, D]),
    ("triplet_p1_swap", lambda P, a, p, n: F(P).triplet_margin_loss(
        a, p, n, p=1.0, swap=True, reduction="none"), [A, B_, D]),
    ("log_loss", lambda P, p, y: F(P).log_loss(p, y), [PROBS, BIN]),
    ("square_error_cost", lambda P, a, b: F(P).square_error_cost(a, b),
     [A, B_]),
    ("sigmoid_focal", lambda P, z, y: F(P).sigmoid_focal_loss(z, y),
     [LOGITS, BIN]),
    ("sigmoid_focal_normalizer", lambda P, z, y, n:
     F(P).sigmoid_focal_loss(z, y, n, reduction="mean"),
     [LOGITS, BIN, np.array([3.0], np.float32)]),
    ("huber", lambda P, a, b: F(P).huber_loss(a * 3, b, delta=0.7),
     [A, B_]),
    ("soft_margin", lambda P, x, y: F(P).soft_margin_loss(x, y),
     [A[:, 0].copy(), PM1]),
    ("multi_margin", lambda P, x, y: F(P).multi_margin_loss(x, y),
     [LOGITS, LAB]),
    ("multi_margin_p2_weight", lambda P, x, y, w: F(P).multi_margin_loss(
        x, y, p=2, margin=0.5, weight=w, reduction="sum"), [LOGITS, LAB, W]),
    ("multi_label_soft_margin", lambda P, x, y, w:
     F(P).multi_label_soft_margin_loss(x, y, w), [LOGITS, BIN, W]),
    ("dice", lambda P, x, y: F(P).dice_loss(x, y),
     [SOFT.reshape(2, 3, C), LAB.reshape(2, 3, 1)]),
    ("npair", lambda P, a, p, y: F(P).npair_loss(a, p, y),
     [A, B_, np.array([0, 1, 0, 2, 1, 2], np.int64)]),
    ("margin_ce", lambda P, z, y: F(P).margin_cross_entropy(
        z, y, return_softmax=True, reduction="sum"),
     [np.tanh(LOGITS), LAB]),
    ("triplet_distance", lambda P, a, p, n:
     F(P).triplet_margin_with_distance_loss(a, p, n), [A, B_, D]),
    ("triplet_distance_fn_swap", lambda P, a, p, n:
     F(P).triplet_margin_with_distance_loss(
         a, p, n, distance_function=lambda u, v: ((u - v) ** 2).sum(-1),
         swap=True, reduction="sum"), [A, B_, D]),
]


@pytest.mark.parametrize("fn,arrays", [c[1:] for c in LOSSES],
                         ids=[c[0] for c in LOSSES])
def test_loss_functional(fn, arrays):
    grad = tuple(i for i, a in enumerate(arrays)
                 if a.dtype == np.float32 and i < 3)
    assert_fn_parity(fn, arrays, grad=grad)
