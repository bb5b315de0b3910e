"""The sequence and tree losses (CTC, RNN-T, hierarchical sigmoid) and
every loss layer of the port against the JAX package's, on the same numpy
inputs (``test_torch_api_nn_losses.py``'s): forward and the gradients of
the floating inputs and of the layers' parameters, float32 within 1e-5
relative and 1e-6 absolute (CTC and RNN-T within 1e-5 absolute, their sums
run in another order)."""
import numpy as np
import pytest

from test_torch_api_nn_losses import (A, B_, BIN, D, F, LAB, LABELS, LOGITS,
                                      PM1, PROBS, SOFT, W, _logp)
from torch_nn_parity import assert_fn_parity, assert_layer_parity, rand
from torch_threads import two_intra_op_threads  # noqa: F401 (autouse)


@pytest.mark.parametrize("kind", ["default", "bias", "custom"])
def test_hsigmoid_loss(kind):
    x = rand(4, 6, seed=11)
    y = np.array([0, 3, 6, 2], np.int64)
    w = rand(6, 6, seed=12)             # num_classes 7: 6 internal nodes
    b = rand(6, 1, seed=13)
    table = np.array([[0, 1, 3], [0, 2, -1], [0, 1, 4], [0, 2, 5]], np.int64)
    code = np.array([[1, 0, 1], [0, 1, 0], [1, 1, 0], [0, 0, 1]], np.int64)
    if kind == "custom":
        def fn(P, x, y, w, b, t, c):
            return F(P).hsigmoid_loss(x, y, 7, w, b, t, c)
        arrays = [x, y, w, b, table, code]
    else:
        def fn(P, x, y, w, *b):
            return F(P).hsigmoid_loss(x, y, 7, w, b[0] if b else None)
        arrays = [x, y, w] + ([b] if kind == "bias" else [])
    assert_fn_parity(fn, arrays, grad=(0, 2) + ((3,) if len(arrays) > 3
                                                 else ()))


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_ctc_loss(reduction):
    """torch's CTC under the reference's normalisation ("mean" over each
    loss divided by its label length) and its log-softmax of the input."""
    t, n, c = 10, 3, 5
    lp = rand(t, n, c, seed=14, lo=-2, hi=2)
    labels = np.array([[1, 2, 2], [3, 1, 0], [4, 4, 1]], np.int64)
    in_len = np.array([10, 8, 9], np.int64)
    lab_len = np.array([3, 2, 3], np.int64)
    assert_fn_parity(lambda P, a, b, c_, d: F(P).ctc_loss(
        a, b, c_, d, blank=0, reduction=reduction),
        [lp, labels, in_len, lab_len], grad=(0,), atol=1e-5)


@pytest.mark.parametrize("lam", [0.001, 0.0], ids=["fastemit", "plain"])
def test_rnnt_loss(lam):
    x = rand(2, 5, 4, 6, seed=15, lo=-2, hi=2)     # [B, T, U + 1, V]
    labels = np.array([[1, 2, 3], [4, 5, 0]], np.int64)
    in_len = np.array([5, 4], np.int64)
    lab_len = np.array([3, 2], np.int64)
    assert_fn_parity(lambda P, a, b, c, d: F(P).rnnt_loss(
        a, b, c, d, fastemit_lambda=lam), [x, labels, in_len, lab_len],
        grad=(0,), atol=1e-5)


def _ce_layer(P):
    return P.nn.CrossEntropyLoss(weight=P.to_tensor(W), label_smoothing=0.1)


LAYERS = [
    ("CrossEntropyLoss", _ce_layer, [LOGITS, LABELS]),
    ("MSELoss", lambda P: P.nn.MSELoss(), [A, B_]),
    ("L1Loss", lambda P: P.nn.L1Loss("none"), [A, B_]),
    ("NLLLoss", lambda P: P.nn.NLLLoss(), [_logp(), LABELS]),
    ("BCELoss", lambda P: P.nn.BCELoss(), [PROBS, BIN]),
    ("BCEWithLogitsLoss", lambda P: P.nn.BCEWithLogitsLoss(
        pos_weight=P.to_tensor(W)), [LOGITS, BIN]),
    ("KLDivLoss", lambda P: P.nn.KLDivLoss("sum"), [_logp(), SOFT]),
    ("SmoothL1Loss", lambda P: P.nn.SmoothL1Loss(), [A, B_]),
    ("MarginRankingLoss", lambda P: P.nn.MarginRankingLoss(0.2),
     [A[:, 0].copy(), B_[:, 0].copy(), PM1]),
    ("HingeEmbeddingLoss", lambda P: P.nn.HingeEmbeddingLoss(),
     [A[:, 0].copy(), PM1]),
    ("CosineEmbeddingLoss", lambda P: P.nn.CosineEmbeddingLoss(),
     [A, B_, PM1]),
    ("TripletMarginLoss", lambda P: P.nn.TripletMarginLoss(swap=True),
     [A, B_, D]),
    ("SoftMarginLoss", lambda P: P.nn.SoftMarginLoss(),
     [A[:, 0].copy(), PM1]),
    ("MultiMarginLoss", lambda P: P.nn.MultiMarginLoss(p=2), [LOGITS, LAB]),
    ("MultiLabelSoftMarginLoss", lambda P: P.nn.MultiLabelSoftMarginLoss(),
     [LOGITS, BIN]),
    ("TripletMarginWithDistanceLoss",
     lambda P: P.nn.TripletMarginWithDistanceLoss(margin=0.5), [A, B_, D]),
    ("HSigmoidLoss", lambda P: P.nn.HSigmoidLoss(8, 7),
     [A[:4].copy(), np.array([0, 3, 6, 2], np.int64)]),
]


@pytest.mark.parametrize("make,arrays", [c[1:] for c in LAYERS],
                         ids=[c[0] for c in LAYERS])
def test_loss_layer(make, arrays):
    grad = tuple(i for i, a in enumerate(arrays) if a.dtype == np.float32
                 and i < 2)
    assert_layer_parity(make, arrays, grad=grad)


def test_ctc_and_rnnt_layers():
    lp = rand(6, 2, 4, seed=16)
    ctc = [lp, np.array([[1, 2], [3, 3]], np.int64),
           np.array([6, 5], np.int64), np.array([2, 2], np.int64)]
    assert_layer_parity(lambda P: P.nn.CTCLoss(reduction="sum"), ctc,
                        atol=1e-5)
    rnnt = [rand(1, 3, 3, 4, seed=17), np.array([[1, 2]], np.int64),
            np.array([3], np.int64), np.array([2], np.int64)]
    assert_layer_parity(lambda P: P.nn.RNNTLoss(), rnnt, atol=1e-5)


def test_cross_entropy_under_amp_is_float32():
    """Black-listed by AMP in both: bf16 logits give a float32 loss."""
    import paddle_tpu_torch as tp
    tp.set_device("cpu")
    x = tp.to_tensor(LOGITS).astype("bfloat16")
    with tp.amp.auto_cast(level="O2"):
        loss = tp.nn.functional.cross_entropy(x, tp.to_tensor(LAB),
                                              label_smoothing=0.1)
    assert str(loss.dtype) == "float32"
