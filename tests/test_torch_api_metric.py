"""``paddle.metric`` of the port against the JAX package's: ``Accuracy``
(top 1, and top 1 and 5 together), ``Precision``, ``Recall``, ``Auc`` and
``accuracy`` over the same seeded batches, each update's and the final
accumulation equal (counts are exact; the AUC's sums are of integers and
halves)."""
import numpy as np
import pytest

from torch_nn_parity import both

N_BATCHES, B, C = 4, 16, 10


def _batches(seed, classes=C):
    rng = np.random.RandomState(seed)
    return [(rng.rand(B, classes).astype(np.float32),
             rng.randint(0, classes, (B, 1)).astype(np.int64))
            for _ in range(N_BATCHES)]


def _accuracy_run(P, topk):
    m = P.metric.Accuracy(topk=topk)
    seen = []
    for pred, label in _batches(0):
        correct = m.compute(P.to_tensor(pred), P.to_tensor(label))
        seen.append(m.update(correct))
    return seen, m.accumulate(), m.name()


@pytest.mark.parametrize("topk", [(1,), (1, 5)])
def test_accuracy_matches_jax(topk):
    jp, tp = both()
    assert _accuracy_run(tp, topk) == _accuracy_run(jp, topk)


def test_precision_recall_auc_match_jax():
    res = {}
    for P in both():
        ms = [P.metric.Precision(), P.metric.Recall(),
              P.metric.Auc(num_thresholds=255)]
        seen = []
        for pred, label in _batches(1, classes=2):
            probs = pred / pred.sum(-1, keepdims=True)
            for m in ms[:2]:
                m.update(P.to_tensor(probs[:, 1]), P.to_tensor(label))
            ms[2].update(P.to_tensor(probs), P.to_tensor(label))
            seen.append([m.accumulate() for m in ms])
        res[P] = (seen, [m.name() for m in ms])
        for m in ms:
            m.reset()
        assert [m.accumulate() for m in ms] == [0.0, 0.0, 0.0]
    jp, tp = both()
    assert res[tp] == res[jp]


@pytest.mark.parametrize("k", [1, 3])
def test_accuracy_function_matches_jax(k):
    pred, label = _batches(2)[0]
    got, want = (float(P.metric.accuracy(P.to_tensor(pred),
                                         P.to_tensor(label), k=k).numpy())
                 for P in reversed(both()))
    assert got == want
